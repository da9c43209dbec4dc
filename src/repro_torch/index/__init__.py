"""Vector and attribute indexes of the port (mirrors ``repro.index``)."""
