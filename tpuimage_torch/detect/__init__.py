"""Host-side detection helpers: the contour walk of DocScanner's quad fit
and the Haar cascade detector of the face pipeline."""
