"""Data of the port: the synthetic token pipeline (``data/pipeline.py``)."""
