"""Device runtime shared by the executors (the paper's Metal pipeline layer)."""
