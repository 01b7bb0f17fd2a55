"""Host-side detection helpers: the contour walk of DocScanner's quad fit."""
