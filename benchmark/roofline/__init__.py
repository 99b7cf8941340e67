"""The least time an NVIDIA H100 could take for the benchmark's work, counted
from the algorithm and the inputs (``count``), never from a kernel."""
