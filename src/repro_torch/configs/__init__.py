"""Search workload configurations (copies of ``repro.configs``)."""
