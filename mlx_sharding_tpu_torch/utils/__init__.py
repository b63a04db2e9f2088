"""Framework-free helpers of the port (``utils/observability.py``, the
named-lock helper)."""
