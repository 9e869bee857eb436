"""The decoder families of the serving path: layers, the MoE FFN, the
recurrent mixers, model assembly, parameter conversion."""
