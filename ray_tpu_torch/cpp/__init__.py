"""The port's C++ worker API: ``include/ray_tpu_torch/client.h``,
``src/client.cc`` and the example programs under ``examples/``, built by
``build.py`` on first use."""
