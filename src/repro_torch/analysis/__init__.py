"""Correctness tooling for the port's device-residency invariants.

Two rails, as in the JAX package (``repro.analysis``):

* **Static**: ``repro_torch.analysis.replint`` (stdlib-only: it imports no
  torch, numpy, jax or ``repro``): an AST rule engine over the port's source.
  Run it as

      python -m repro_torch.analysis.replint src/repro_torch

  Its rules are aimed at the port's own boundaries. JAX rule -> port rule:

  * REP001 (host materialization in jit-reachable code) -> **PT001**, a
    host sync (``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
    ``int()`` of a tensor, ``torch.nonzero``, an upload) in any function
    reachable from a guarded region (``with sanitize.guard(...)``) outside
    the engines' two explicit crossings, ``_upload`` and ``_readback``;
  * REP002 (Pallas input/output aliasing indices) -> **PT002**, the ctypes
    boundary: each C call in ``kernels/*.py`` and its ``_SIGNATURES`` entry
    against the ``extern "C"`` declaration in ``csrc/<lib>.cu`` (argument
    count; pointer against integer kinds);
  * REP003 (recompile risks) -> **none**: the port has no trace and no JIT,
    nothing in it recompiles per call or per shape; a kernel library is
    built once, keyed by a hash of its sources and flags (``_build``), and
    the runtime rail's build budgets hold that;
  * REP004 (64-bit dtypes in kernel modules) -> **PT004**, no 64-bit tensor
    handed to a C entry's 32-bit pointer (``.long()`` for torch indexing in
    the plain versions is legal);
  * REP005 (module-level ``jnp`` computation) -> **PT005**, nothing at
    import touches the card (module-level tensors, ``torch.cuda.*``,
    ``.cuda()`` / ``.to()``; ``torch.finfo`` / ``iinfo`` and dtypes exempt).

  A finding is suppressed only by a reasoned pragma,
  ``# port-lint: disable=PT001(reason)``; a bare one is itself a finding
  (PT000). The keyword and codes differ from the JAX rail's on purpose: the
  JAX rail scans ``src/``, the port included, and must not read these.

* **Runtime**: ``repro_torch.analysis.sanitize`` (imports torch): the sync
  guard the engines run their query and device-flush paths under in
  sanitizer mode (``REPRO_SANITIZE=1``), transfer counts, kernel-build
  counts checked against ``tools/torch_build_budgets.json``, a post-flush
  table scan, and a replay of the in-place kernels on poisoned inputs.

``sanitize`` is deliberately NOT imported here: the static rail must stay
importable without torch.
"""
