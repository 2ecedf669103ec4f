"""Dry-run analysis of the port: the bytes model, the roofline and the report tables."""
