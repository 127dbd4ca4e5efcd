"""Bayesian-optimization channel search (part (b) of the study): Gryffin
over the 12-channel MDES space, its mean-field surrogate and kernel density
in torch, the numpy acquisition search, Chimera, the history database and
the float64 C kernel evaluator. Port of the JAX package's ``search/``."""
