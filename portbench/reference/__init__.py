"""The benchmark's plain reference of the exact frame (``frame.render``)
and the camera matrices it is given (``camera``). Plain PyTorch and NumPy:
it imports nothing of the renderer under test."""
