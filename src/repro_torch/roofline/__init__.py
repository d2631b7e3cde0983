"""The roofline of the port's steps: ``model`` (the three terms at the
H100's data-sheet figures) and ``count`` (a step's flops, bytes and
collective bytes, counted from an eager run)."""
