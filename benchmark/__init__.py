"""The benchmark of giddy_tpu_torch on one NVIDIA H100 (see run.py).

Everything here is the yardstick: data generation from the seed, the
traffic mixes and the loops that run them (runners/), the plain reference,
the comparison that decides ``correct``, the reading of the profiler trace,
the kernels' byte counts and the metrics. The program under test is
reached only through system.py; control.py stands in for it.
"""
