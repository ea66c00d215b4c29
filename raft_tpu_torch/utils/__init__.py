"""Host utilities without OpenCV: flow file I/O, flow visualization and
the classical frame tools (the JAX package's ``utils/``)."""
