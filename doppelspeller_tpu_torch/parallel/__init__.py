"""Multi-device execution (``sharded.py``)."""
