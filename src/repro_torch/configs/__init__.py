"""Search and model configurations (copies of ``repro.configs``)."""
