"""Framework-neutral helpers of the port (NumPy only)."""
