"""Pipelines: DocScanner, night, morph_seq, landscape, face and the
notebook's (the shadow-protected enhancement, modules 1-7, the document
restoration)."""
