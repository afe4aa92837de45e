"""Analysis tooling of the port.

* :mod:`repro_torch.analysis.kvsan` — page-lifetime sanitizer over the
  serving engines' :class:`~repro_torch.serving.kvpool.PagePool`
  (``REPRO_KVSAN=1``).
* :mod:`repro_torch.analysis.invariants` — control-plane invariant
  checker run on every router tick when the sanitizer is enabled.
* :mod:`repro_torch.analysis.compile_tracker` — capture budgets for the
  engines' step graphs (``REPRO_JITAUDIT=1``).
* :mod:`repro_torch.analysis.fuzz` — randomized replay fuzzer that drives
  the router under the sanitizer (``python -m repro_torch.analysis.fuzz``);
  ``--compile-audit`` also arms the compile tracker per round.

The first two are copies of the reference's pure-Python modules; the
tracker counts graph captures where the reference counted jit lowerings. This
``__init__`` stays import-light: ``kvpool`` and ``radix_tree`` import
:mod:`repro_torch.analysis.kvsan` at module load.
"""
