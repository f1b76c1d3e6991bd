"""Label diagnostics of the port (host, numpy)."""
