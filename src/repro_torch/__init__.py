"""The cached trie join (Flexible Caching in Trie Joins) in PyTorch, with
hand-written CUDA kernels for Hopper.

Layout mirrors the JAX reference package ``repro``:

  * ``core``    — planning (cq / gaifman / separators / td / decompose),
    data (db), the frontier engines, the op schedule and its executor,
    the tier-2 cache, and the ``engine`` facade;
  * ``data``    — synthetic graph workloads;
  * ``kernels`` — the kernel registry, each kernel's plain PyTorch version
    and CUDA wrapper; ``csrc`` holds the CUDA sources;
  * ``configs`` — ``JoinEngineConfig`` and its presets;
  * ``serve``   — the query server: plan cache, snapshots, sessions;
  * ``convert`` — the reference's database, query, plan, tables and
    engine config carried across.
"""
