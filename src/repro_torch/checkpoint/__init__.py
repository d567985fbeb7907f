"""Model-store artifacts of trained or converted transformers."""
