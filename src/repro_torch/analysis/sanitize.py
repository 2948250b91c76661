"""Runtime sanitizer rail of the port: sync guard, build budgets, table scans.

The static rail (``repro_torch.analysis.replint``) proves properties of the
source; this module checks the ones only an execution can see. It is the
counterpart of ``repro.analysis.sanitize``, function for function:

* ``no_transfers(tag)`` / ``guard(tag)``: torch's sync debug mode set to
  ``"error"`` for the length of the block, the counterpart of
  ``jax.transfer_guard("disallow")``. On a CUDA device an *implicit* crossing
  (``.item()``, ``.cpu()``, a blocking upload, ``torch.nonzero``, a boolean
  mask index) raises, as a ``SanitizerError`` naming the path. The explicit
  crossings stay legal: they go through ``upload`` (``EngineCore._upload``)
  and ``EngineCore._readback``, which run inside ``explicit()`` and are the
  only code that lifts the mode. The engines guard their query and device-flush
  paths when ``REPRO_SANITIZE=1``. Torch's mode acts on CUDA work only: on
  CPU tensors nothing syncs and nothing raises, so only a run on the card
  shows the guard firing.
* ``count_transfers()``: ``h2d`` counts upload-helper calls and ``d2h``
  readback-helper calls, the counterpart of the JAX rail's ``device_put`` /
  ``np.asarray`` interposition. A call counts on any device, so a CPU run
  counts what the same calls cross on the card.
* ``count_builds()`` / ``assert_builds_within()``: the kernel libraries
  ``repro_torch.kernels._build`` compiles inside the block, held to
  ``tools/torch_build_budgets.json`` (``REPRO_BUILD_BUDGETS`` overrides the
  path). The port has no trace and no JIT; its compiles are the ``nvcc``
  builds, one library a kernel source, keyed by a hash of the sources.
* ``enable_compile_cache(path)``: names the kernels' build directory, so a
  second process over the same directory builds nothing.
* ``scan_tables()``: the post-flush invariant scan, the JAX rail's checks
  and messages.
* ``check_kernel_aliasing(device=...)``: replays the kernels that read or
  write the live tables in place on *poisoned* inputs (trap weights behind
  -1 ids, a trap dummy row, separate table copies) and holds each kernel to
  its plain version, exact.

Everything raises ``repro_torch.core.errors.SanitizerError`` on a violation.
"""
from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.errors import SanitizerError

# the message of torch's RuntimeError under sync debug mode "error"
_SYNC_MESSAGE = "synchronizing CUDA operation"
_MODE_ERROR = 2


def enabled() -> bool:
    """Sanitizer mode: set ``REPRO_SANITIZE=1`` (the sanitizer CI leg)."""
    return os.environ.get("REPRO_SANITIZE", "").lower() in ("1", "true", "yes", "on")


# ---------------------------------------------------------------------------
# sync guard
# ---------------------------------------------------------------------------


def _get_mode() -> int:
    return torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else 0


def _set_mode(mode: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def _sync_mode(mode: int):
    """Torch's sync debug mode set to ``mode`` inside the block; the mode the
    block found comes back on exit, exceptions included, so nested guards
    and helpers restore what they found."""
    before = _get_mode()
    if before == mode:
        yield
        return
    _set_mode(mode)
    try:
        yield
    finally:
        _set_mode(before)


def is_sync_error(e: BaseException) -> bool:
    """Is ``e`` torch's error for a synchronizing operation under the guard?"""
    return (isinstance(e, RuntimeError) and not isinstance(e, SanitizerError)
            and _SYNC_MESSAGE in str(e))


@contextlib.contextmanager
def no_transfers(tag: str = ""):
    """Disallow implicit host<->device syncs inside the block."""
    try:
        with _sync_mode(_MODE_ERROR):
            yield
    except RuntimeError as e:
        if is_sync_error(e):
            where = f" on the `{tag}` path" if tag else ""
            raise SanitizerError(
                f"implicit host sync{where}: {e}\n"
                "Upload through EngineCore._upload and read back through "
                "EngineCore._readback; never let a tensor reach .item(), .cpu(), "
                "int() or a boolean index on a guarded path."
            ) from e
        raise


def guard(tag: str = ""):
    """``no_transfers(tag)`` when sanitizer mode is on, else a no-op."""
    return no_transfers(tag) if enabled() else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# transfer counting
# ---------------------------------------------------------------------------


class TransferCounter:
    def __init__(self):
        self.h2d = 0
        self.d2h = 0

    @property
    def total(self) -> int:
        return self.h2d + self.d2h


_COUNTERS: list[TransferCounter] = []


@contextlib.contextmanager
def count_transfers():
    """Count the explicit host<->device crossings inside the block: ``h2d``
    the upload helper's calls, ``d2h`` the readback helper's. Meant to run
    together with ``no_transfers``, which rules the implicit ones out."""
    counter = TransferCounter()
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


@contextlib.contextmanager
def explicit(direction: str):
    """One explicit crossing (``"h2d"`` or ``"d2h"``): counted, and run with
    the sync guard lifted. Only ``upload`` and the engines' ``_readback``
    enter it."""
    for counter in _COUNTERS:
        setattr(counter, direction, getattr(counter, direction) + 1)
    with _sync_mode(0):
        yield


def upload(x: np.ndarray, device) -> torch.Tensor:
    """The port's host -> device crossing (``EngineCore._upload``,
    ``construct.object_extras``): ``x`` on ``device``, counted as ``h2d``
    here and as ``h2d_bytes`` in the outermost program span, inside a
    ``repro_torch.upload`` span (``repro_torch.trace``)."""
    with trace.span("repro_torch.upload"), explicit("h2d"):
        x = np.ascontiguousarray(x)
        trace.count("h2d_bytes", x.nbytes)
        return torch.from_numpy(x).to(device)


# ---------------------------------------------------------------------------
# build counting + budgets
# ---------------------------------------------------------------------------


class BuildCounter:
    """Kernel libraries compiled while the context was live (``libraries``
    names them; ``count`` is their number, live inside the block)."""

    def __init__(self, start: int):
        self._start = start
        self._end: int | None = None

    @property
    def libraries(self) -> list[str]:
        from repro_torch.kernels import _build

        return list(_build.BUILT[self._start:self._end])

    @property
    def count(self) -> int:
        return len(self.libraries)


@contextlib.contextmanager
def count_builds():
    from repro_torch.kernels import _build

    counter = BuildCounter(len(_build.BUILT))
    try:
        yield counter
    finally:
        counter._end = len(_build.BUILT)


def enable_compile_cache(path: str | os.PathLike | None = None) -> Path | None:
    """Name the kernels' build directory ``path``.

    ``path`` defaults to the ``REPRO_COMPILE_CACHE`` env var; returns the
    directory (created if missing), or None when neither is set (the call is
    then a no-op, so serve.py can wire it unconditionally, and the build
    directory stays ``build/`` beside ``src/``). The directory is handed to
    ``kernels._build`` through ``REPRO_COMPILE_CACHE``, which child
    processes inherit. A library's file name is a hash of its sources and
    flags, so a second process over the same directory loads what the first
    built and compiles nothing.
    """
    path = path or os.environ.get("REPRO_COMPILE_CACHE") or None
    if not path:
        return None
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_COMPILE_CACHE"] = str(path)
    return path


def budgets_path() -> Path:
    env = os.environ.get("REPRO_BUILD_BUDGETS")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "tools" / "torch_build_budgets.json"


def load_budgets() -> dict:
    with open(budgets_path()) as f:
        return json.load(f)


def assert_builds_within(api: str, cold: int | None = None, warm: int | None = None):
    """Check measured build counts against the checked-in budget.

    ``warm`` must EQUAL the budget (a warm path that builds at all is a
    regression; a budget that is too loose is stale and must be lowered).
    ``cold`` must not exceed ``cold_max``.
    """
    budget = load_budgets().get(api)
    if budget is None:
        raise SanitizerError(f"no build budget for `{api}` in {budgets_path()}; add one")
    if cold is not None and cold > budget["cold_max"]:
        raise SanitizerError(
            f"`{api}` cold path built {cold} kernel libraries, budget cold_max="
            f"{budget['cold_max']} ({budgets_path()})"
        )
    if warm is not None and warm != budget["warm"]:
        raise SanitizerError(
            f"`{api}` warm path built {warm} kernel libraries, budget requires "
            f"exactly {budget['warm']} ({budgets_path()}); a higher count is a "
            "rebuild regression, a lower budget means the file is stale"
        )


# ---------------------------------------------------------------------------
# post-flush table scan
# ---------------------------------------------------------------------------


def scan_tables(ids, dists, n: int, *, context: str = "") -> None:
    """Invariant scan of host-layout (rows, k) tables; raises on corruption.

    Checked: ids int-typed in [-1, n); no NaN; no negative distance; rows
    ascending (ties allowed); pad slots (id == -1) at +inf and packed to
    the right of every real entry.
    """
    ids = np.asarray(ids)
    d = np.asarray(dists)
    where = f" ({context})" if context else ""
    problems = []
    if np.isnan(d).any():
        problems.append(f"{int(np.isnan(d).sum())} NaN distances")
    if (d < 0).any():
        problems.append(f"{int((d < 0).sum())} negative distances")
    if ids.size:
        if int(ids.min()) < -1 or int(ids.max()) >= n:
            problems.append(f"ids outside [-1, {n}): min={int(ids.min())} max={int(ids.max())}")
        pad = ids < 0
        if not np.isinf(np.where(pad, d, np.inf)).all():
            problems.append("pad slots (id=-1) carrying finite distances")
        # pads packed right: a real id after a pad breaks the k-list contract
        if (np.diff(pad.astype(np.int8), axis=1) < 0).any():
            problems.append("real entries to the right of pad slots")
        dd = np.where(pad, np.inf, d)
        fin = np.isfinite(dd[:, 1:]) & np.isfinite(dd[:, :-1])
        with np.errstate(invalid="ignore"):  # inf - inf on pad tails
            if (np.where(fin, np.diff(dd, axis=1), 0.0) < 0).any():
                problems.append("rows not sorted by distance")
    if problems:
        raise SanitizerError(f"post-flush table scan failed{where}: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# aliasing sanitizer: poisoned kernels vs their plain versions
# ---------------------------------------------------------------------------

_TRAP = np.float32(7e7)  # finite, absurd, impossible to produce legally


def _distinct_rows(ids: np.ndarray, n: int) -> np.ndarray:
    """Each row's ids made distinct: its first id and the next ones mod n."""
    return ((ids[:, :1] + np.arange(ids.shape[1])) % n).astype(np.int32)


def poisoned_cases(k: int = 4, seed: int = 0) -> dict:
    """The poisoned inputs of ``check_kernel_aliasing``, as numpy arrays.

    ``sweep_merge`` and ``frontier_relax`` are the JAX rail's two cases, drawn
    in the same order from the same generator, so the JAX reference runs on
    the very arrays, but for K2's table ids: each row's are made distinct
    from its first, as K2's row bound needs of the rows it reads.
    ``sweep_merge_levels``, ``frontier_relax_rows`` and ``rows_purge_merge``
    are the port's in-place entries, which the JAX rail has no counterpart
    of: their trap slots sit where the kernel must not read (pad neighbour
    slots, rows outside the batch, the dummy row) or must not write (the
    dummy row, rows outside the batch, the read-only operands).
    """
    rng = np.random.default_rng(seed)
    trap = _TRAP
    cases: dict = {}

    # --- K2 tile: (chunk, t) gather over the live tables ------------------
    n, chunk, t, e = 12, 4, 3, 2
    n1 = n + 1
    # level-schedule contract: target rows and neighbour rows are disjoint
    # within a call (targets even, neighbours odd)
    nbr = (rng.integers(0, n // 2, (chunk, t)) * 2 + 1).astype(np.int32)
    nbr[0, -1] = -1  # a padded neighbour slot
    verts = np.arange(chunk, dtype=np.int32) * 2
    w = rng.uniform(0.5, 2.0, (chunk, t)).astype(np.float32)
    w[nbr < 0] = trap  # poisoned: must be masked by the id, not the weight
    ex_ids = np.full((n1, e), -1, np.int32)
    ex_ids[: n // 2] = rng.integers(0, n, (n // 2, e), dtype=np.int32)
    ex_d = np.where(ex_ids >= 0, rng.uniform(0, 3, (n1, e)), trap).astype(np.float32)
    # the tables' rows as K2 writes them, which its row bound rests on:
    # distinct ids (consecutive from the drawn first), distances ascending
    vk_ids = _distinct_rows(rng.integers(0, n, (n1, k), dtype=np.int32), n)
    vk_d = np.sort(rng.uniform(0, 5, (n1, k)), axis=1).astype(np.float32)
    vk_ids[-1] = -1
    vk_d[-1] = trap  # poisoned dummy row: reads of it must be id-masked
    cases["sweep_merge"] = dict(nbr=nbr, verts=verts, w=w, ex_ids=ex_ids, ex_d=ex_d,
                                vk_ids=vk_ids, vk_d=vk_d)

    # --- K3 tile: Jacobi read discipline -----------------------------------
    r, tt, b = 5, 3, 4
    nbr2 = rng.integers(0, n, (r, tt), dtype=np.int32)
    nbr2[1, -1] = -1
    rows = rng.choice(n, r, replace=False).astype(np.int32)
    w2 = rng.uniform(0.5, 2.0, (r, tt)).astype(np.float32)
    w2[nbr2 < 0] = trap
    dist = rng.uniform(0, 4, (n1, b)).astype(np.float32)
    dist[-1] = np.inf  # dummy row
    kth = np.full(n1, 3.0, np.float32)
    kth[-1] = np.inf
    src = rng.integers(0, n, b, dtype=np.int32)
    cases["frontier_relax"] = dict(nbr=nbr2, rows=rows, w=w2, dist=dist, kth=kth, src=src)

    # --- K3 fused rows: the receivers' rows of (n+1, T) bucket tables -----
    # rows outside the batch hold live-looking neighbours at weight 0: a
    # kernel reading the wrong row of the tables diverges
    nbr_tab = rng.integers(0, n, (n1, tt), dtype=np.int32)
    w_tab = np.zeros((n1, tt), np.float32)
    nbr_tab[rows] = nbr2
    w_tab[rows] = w2
    nbr_tab[-1] = -1
    w_tab[-1] = trap
    cases["frontier_relax_rows"] = dict(nbr_tab=nbr_tab, w_tab=w_tab, rows=rows, dist=dist,
                                        kth=kth, src=src)

    # --- K2 levels: a whole sweep in place, level after level --------------
    # level 0 writes rows 0, 2 from odd rows; level 1 rows 4, 6 from rows of
    # level 0 and odd rows; level 2 row 8 and a padded row (verts == n) from
    # everything before. Two buckets of widths 2 and 3.
    lv_nbr = [np.array([[1, 3], [5, -1]], np.int32),
              np.array([[0, 2, 7], [2, 9, -1], [4, 6, 11], [-1, -1, -1]], np.int32)]
    lv_verts = [np.array([0, 2], np.int32), np.array([4, 6, 8, n], np.int32)]
    lv_w = [rng.uniform(0.5, 2.0, x.shape).astype(np.float32) for x in lv_nbr]
    for x, wx in zip(lv_nbr, lv_w):
        wx[x < 0] = trap
    levels = np.array([[0, 0, 2], [1, 0, 2], [1, 2, 2]], np.int32)
    lv_vk_ids = _distinct_rows(rng.integers(0, n, (n1, k), dtype=np.int32), n)
    lv_vk_d = np.sort(rng.uniform(0, 5, (n1, k)), axis=1).astype(np.float32)
    lv_vk_ids[-1] = -1
    lv_vk_d[-1] = trap  # the dummy row: id-masked on read, never written
    cases["sweep_merge_levels"] = dict(
        buckets=[(x, wx, v) for x, wx, v in zip(lv_nbr, lv_w, lv_verts)], levels=levels,
        ex_ids=ex_ids, ex_d=ex_d, vk_ids=lv_vk_ids, vk_d=lv_vk_d)

    # --- K1 in place: purge + candidate merge over a row batch -------------
    pm_rows = np.array([1, 4, 5, 9], np.int32)
    pm_ids = np.sort(rng.choice(n, (n1, k)), axis=1).astype(np.int32)
    pm_d = np.sort(rng.uniform(0, 5, (n1, k)), axis=1).astype(np.float32)
    pm_ids[-1] = -1
    pm_d[-1] = trap
    del_ids = np.array([int(pm_ids[1, 0]), int(pm_ids[5, 1])], np.int32)
    p = 4
    cand_ids = rng.integers(0, n, (len(pm_rows), p), dtype=np.int32)
    cand_ids[:, -1] = -1  # pad candidate slots with trap distances behind them
    cand_d = rng.uniform(0, 5, (len(pm_rows), p)).astype(np.float32)
    cand_d[cand_ids < 0] = trap
    cases["rows_purge_merge"] = dict(vk_ids=pm_ids, vk_d=pm_d, rows=pm_rows, del_ids=del_ids,
                                     cand_ids=cand_ids, cand_d=cand_d)
    return cases


def _tensors(case: dict, dev) -> dict:
    out = {}
    for key, val in case.items():
        if key == "buckets":
            out[key] = [tuple(torch.from_numpy(x.copy()).to(dev) for x in b) for b in val]
        else:
            out[key] = torch.from_numpy(np.array(val)).to(dev)
    return out


def _clone(args: dict) -> dict:
    return {key: ([tuple(x.clone() for x in b) for b in val] if key == "buckets"
                  else val.clone()) for key, val in args.items()}


def _flat(args: dict, key: str) -> list:
    return [x for b in args[key] for x in b] if key == "buckets" else [args[key]]


def _replay(name: str, base: dict, run, read_only, cells: dict) -> dict:
    """``run`` on two copies of the poisoned inputs, kernel then plain; every
    output and every written operand held equal, exact, and the read-only
    operands held unwritten. Returns the plain call's operands after it."""
    after = {}
    outs = {}
    for use_kernel in (True, False):
        args = _clone(base)
        got = run(args, use_kernel)
        for key in read_only:
            if not all(torch.equal(x, y) for x, y in zip(_flat(base, key), _flat(args, key))):
                raise SanitizerError(f"{name} wrote its read-only operand `{key}`")
        got.update({key: args[key] for key in args if key not in read_only})
        outs[use_kernel], after = got, args
    for part, want in outs[False].items():
        g = outs[True][part]
        if not torch.equal(g, want):
            bad = int((g != want).sum())
            raise SanitizerError(
                f"{name} diverges from its plain version on poisoned buffers ({part}: "
                f"{bad} cells): a read through a pad slot, the wrong row or a written operand"
            )
        cells[name] = cells.get(name, 0) + g.numel()
    return after


def _rows_kept(name: str, case: dict, after: dict, rows: np.ndarray) -> None:
    """The in-place entry left ``rows`` (the dummy row's trap included) as
    they were."""
    for key in ("vk_ids", "vk_d"):
        if not np.array_equal(after[key].cpu().numpy()[rows], case[key][rows]):
            raise SanitizerError(f"{name} wrote rows outside its batch (`{key}`)")


def check_kernel_aliasing(*, k: int = 4, seed: int = 0, device="cuda") -> dict:
    """Replay the kernels that touch the live tables on poisoned inputs.

    The cases (``poisoned_cases``): K2 as a tile (``ops.sweep_merge``) and as
    a whole sweep in place (``ops.sweep_merge_levels``), K3 through both of
    its entries (``ops.frontier_relax``, ``ops.frontier_relax_rows``), K1 in
    place (``ops.rows_purge_merge``). On a CUDA device each kernel
    (``use_kernel=True``) is held to its plain version (``use_kernel=False``)
    on separate copies of the same inputs, exact (``torch.equal``): outputs
    and written tables alike. On the CPU both calls run the plain version, so
    only the device-independent half is a check there: the read-only
    operands stay unwritten and the in-place entries leave every row outside
    their batch (the dummy row's trap included) as it was. Returns the cells
    compared a case; raises ``SanitizerError`` on any divergence.
    """
    from repro_torch.kernels import ops

    dev = torch.device(device)
    cases = poisoned_cases(k, seed)
    cells: dict = {}

    def base(name):
        return _tensors(cases[name], dev)

    _replay("sweep_merge", base("sweep_merge"), lambda a, uk: dict(zip(
        ("ids", "dists"), ops.sweep_merge(a["nbr"], a["verts"], a["w"], a["ex_ids"], a["ex_d"],
                                          a["vk_ids"], a["vk_d"], k, use_kernel=uk))),
        ("nbr", "verts", "w", "ex_ids", "ex_d", "vk_ids", "vk_d"), cells)
    _replay("frontier_relax", base("frontier_relax"), lambda a, uk: {
        "tile": ops.frontier_relax(a["nbr"], a["rows"], a["w"], a["dist"], a["kth"], a["src"],
                                   use_kernel=uk)},
        ("nbr", "rows", "w", "dist", "kth", "src"), cells)
    _replay("frontier_relax_rows", base("frontier_relax_rows"), lambda a, uk: dict(zip(
        ("tile", "changed"), ops.frontier_relax_rows(
            a["nbr_tab"], a["w_tab"], a["rows"], a["dist"], a["kth"], a["src"],
            use_kernel=uk))),
        ("nbr_tab", "w_tab", "rows", "dist", "kth", "src"), cells)

    def levels(a, uk):
        ops.sweep_merge_levels(a["buckets"], a["levels"], a["ex_ids"], a["ex_d"],
                               a["vk_ids"], a["vk_d"], k, use_kernel=uk)
        return {}

    case = cases["sweep_merge_levels"]
    n = case["vk_ids"].shape[0] - 1
    written = np.concatenate([v for _, _, v in case["buckets"]])
    after = _replay("sweep_merge_levels", base("sweep_merge_levels"), levels,
                    ("buckets", "levels", "ex_ids", "ex_d"), cells)
    _rows_kept("sweep_merge_levels", case, after,
               np.setdiff1d(np.arange(n + 1), written[written < n]))

    def purge_merge(a, uk):
        ops.rows_purge_merge(a["vk_ids"], a["vk_d"], a["rows"], a["del_ids"], a["cand_ids"],
                             a["cand_d"], k, use_kernel=uk)
        return {}

    case = cases["rows_purge_merge"]
    after = _replay("rows_purge_merge", base("rows_purge_merge"), purge_merge,
                    ("rows", "del_ids", "cand_ids", "cand_d"), cells)
    _rows_kept("rows_purge_merge", case, after,
               np.setdiff1d(np.arange(case["vk_ids"].shape[0]), case["rows"]))
    return cells
