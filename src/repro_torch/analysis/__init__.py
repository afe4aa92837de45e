"""Analysis tooling of the port.

* :mod:`repro_torch.analysis.kvsan` — page-lifetime sanitizer over the
  serving engines' :class:`~repro_torch.serving.kvpool.PagePool`
  (``REPRO_KVSAN=1``).
* :mod:`repro_torch.analysis.invariants` — control-plane invariant
  checker run on every router tick when the sanitizer is enabled.

Both are copies of the reference's pure-Python modules. This
``__init__`` stays import-light: ``kvpool`` and ``radix_tree`` import
:mod:`repro_torch.analysis.kvsan` at module load.
"""
