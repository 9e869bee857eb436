"""The dense decoder family: layers, model assembly, parameter conversion."""
