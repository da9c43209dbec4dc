"""Data model and query node of the port (mirrors ``repro.core``)."""
