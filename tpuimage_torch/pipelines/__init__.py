"""Pipelines: DocScanner's serving path (``docscan.scan_batch``)."""
