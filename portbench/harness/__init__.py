"""The benchmark's own code: the yardstick that later changes to the
program cannot move.

* :mod:`spec` reads ``BENCHMARK.json`` and finds a cell's configuration,
  traffic mix and metric readers by name;
* :mod:`graphs` draws a deployment's relation from its file;
* :mod:`queries` builds the query log of a traffic mix;
* :mod:`reference` is the plain NumPy/SciPy join that decides
  ``correct``;
* :mod:`drivers` drives the program (``repro_torch``) through its
  public entry points over the measured window;
* :mod:`trace` reduces a ``torch.profiler`` trace to device time;
* :mod:`runner` puts one run together and builds its result line.

Nothing here imports ``jax`` or the JAX package ``repro``.
"""
