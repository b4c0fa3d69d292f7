"""Roofline accounting of the port (trace analyzer and the three-term roofline)."""
