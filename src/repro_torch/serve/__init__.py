"""Serving: the continuous-batching engine and token sampling."""
