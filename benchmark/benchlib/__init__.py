"""The harness of the benchmark of ``mulls_tpu_torch``'s fleet odometry:
the catalog of configurations, traffic mixes and per-layer metrics found by
name (:mod:`catalog`), the drives made on the device (:mod:`traffic`), the
run and its window (:mod:`drive`), the trace's reduction to numbers
(:mod:`trace`) and the comparison with the plain reference that decides
``correct`` (:mod:`check`)."""
