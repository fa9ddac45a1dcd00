"""The port's benchmark: the headline entry point (``headline``) and the
operation and byte model of its kernels (``roofline``)."""
