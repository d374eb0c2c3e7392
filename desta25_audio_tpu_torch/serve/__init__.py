"""Serving: the continuous-batching engine (``serve/engine.py``)."""
