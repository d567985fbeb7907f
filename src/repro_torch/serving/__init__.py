"""Serving engines: continuous batching and the multi-model server."""
