"""Multi-device sharding of the port (``parallel/sharding.py``)."""
