"""Test-support utilities shipped with the port (fault injection)."""
