"""LM stack (the port of ``repro.models``): the dense transformer family."""
