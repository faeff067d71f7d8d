"""Global flag registry.

Rebuild of the reference's declarative flag system
(reference: ``spartan/config.py`` — ``FLAGS`` registry with typed flags
registered at import time by any module, parsed from argv; see SURVEY.md
§2.1, §5).  Any module may register a flag; values overlay from (lowest to
highest precedence): declared default → environment (``SPARTAN_<NAME>``) →
argv (``--name=value`` handled by :func:`parse_args`) → programmatic
:func:`set_flag` calls.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional


class Flag:
  """A single typed flag."""

  def __init__(self, name: str, default: Any, help: str = "",
               parser: Optional[Callable[[str], Any]] = None):
    self.name = name
    self.default = default
    self.help = help
    self._parser = parser or type(default)
    self._value = None
    self._is_set = False
    env = os.environ.get("SPARTAN_" + name.upper())
    if env is not None:
      self.set(self.parse(env))

  def parse(self, text: str) -> Any:
    if isinstance(self.default, bool):
      return text.strip().lower() in ("1", "true", "yes", "on")
    return self._parser(text)

  def set(self, value: Any) -> None:
    self._value = value
    self._is_set = True

  def reset(self) -> None:
    self._value = None
    self._is_set = False

  @property
  def value(self) -> Any:
    return self._value if self._is_set else self.default


def BoolFlag(name: str, default: bool = False, help: str = "") -> Flag:
  return Flag(name, bool(default), help)


def IntFlag(name: str, default: int = 0, help: str = "") -> Flag:
  return Flag(name, int(default), help)


def FloatFlag(name: str, default: float = 0.0, help: str = "") -> Flag:
  return Flag(name, float(default), help)


def StrFlag(name: str, default: str = "", help: str = "") -> Flag:
  return Flag(name, str(default), help)


class Flags:
  """Registry of :class:`Flag` objects, attribute-accessible by name."""

  def __init__(self):
    object.__setattr__(self, "_flags", {})

  def add(self, flag: Flag) -> Flag:
    existing = self._flags.get(flag.name)
    if existing is not None:
      return existing
    self._flags[flag.name] = flag
    return flag

  def __getattr__(self, name: str) -> Any:
    flags: Dict[str, Flag] = object.__getattribute__(self, "_flags")
    if name in flags:
      return flags[name].value
    raise AttributeError(f"no flag {name!r} registered")

  def __setattr__(self, name: str, value: Any) -> None:
    flags = self._flags
    if name not in flags:
      raise AttributeError(f"no flag {name!r} registered")
    flags[name].set(value)

  def __contains__(self, name: str) -> bool:
    return name in self._flags

  def lookup(self, name: str) -> Flag:
    return self._flags[name]

  def parse(self, argv: Optional[List[str]] = None) -> List[str]:
    """Consume ``--name=value`` / ``--name value`` / ``--[no]boolflag``
    arguments that match registered flags; return the remainder."""
    if argv is None:
      return []
    rest: List[str] = []
    i = 0
    while i < len(argv):
      arg = argv[i]
      if not arg.startswith("--"):
        rest.append(arg)
        i += 1
        continue
      body = arg[2:]
      if "=" in body:
        name, _, text = body.partition("=")
        name = name.replace("-", "_")
        if name in self._flags:
          f = self._flags[name]
          f.set(f.parse(text))
          i += 1
          continue
      else:
        name = body.replace("-", "_")
        if name in self._flags:
          f = self._flags[name]
          if isinstance(f.default, bool):
            f.set(True)
            i += 1
            continue
          if i + 1 < len(argv):
            f.set(f.parse(argv[i + 1]))
            i += 2
            continue
        if name.startswith("no") and name[2:] in self._flags:
          f = self._flags[name[2:]]
          if isinstance(f.default, bool):
            f.set(False)
            i += 1
            continue
      rest.append(arg)
      i += 1
    return rest

  def reset_all(self) -> None:
    for f in self._flags.values():
      f.reset()

  def snapshot(self) -> Dict[str, Any]:
    return {name: f.value for name, f in self._flags.items()}


FLAGS = Flags()

# ---------------------------------------------------------------------------
# Core flags (reference analogues: --optimization toggles, cluster flags,
# profiling flags — SURVEY.md §2.1 "Config/flags").  Cluster-shape flags are
# replaced by mesh flags: sharding IS placement.
# ---------------------------------------------------------------------------
FLAGS.add(BoolFlag("optimization", True, "master switch for DAG optimizer"))
FLAGS.add(BoolFlag("opt_fusion", True, "fuse map/map chains into one node"))
FLAGS.add(BoolFlag("opt_reduce_fusion", True, "fuse map into reduce kernels"))
FLAGS.add(BoolFlag("opt_collapse_cached", True,
                   "collapse already-evaluated sub-DAGs into leaves"))
FLAGS.add(BoolFlag("opt_auto_tiling", True,
                   "smart-tiling pass: choose output shardings to minimize "
                   "resharding collectives"))
FLAGS.add(BoolFlag("opt_smart_tiling", True,
                   "use the cost-model tiling search (smart_tiling.plan) as "
                   "the production tiling pass — reshard region leaves to the "
                   "argmin layouts and take the planned root out_sharding; "
                   "off = the simpler inheritance heuristic"))
FLAGS.add(IntFlag("smart_tiling_max_nodes", 256,
                  "DAG size above which the tiling cost search falls back to "
                  "the inheritance heuristic (planning is O(nodes*cands^2))"))
FLAGS.add(BoolFlag("opt_affine_reduce", True,
                   "strength-reduce sum(a*x+b) to a*sum(x)+b*n — linear "
                   "reductions run at pure-sum memory speed"))
FLAGS.add(BoolFlag("opt_const_fold", True,
                   "fold broadcast-neutral fill-creations into scalar "
                   "leaves inside fused kernels"))
FLAGS.add(BoolFlag("opt_parakeet_gen", False,
                   "reference parity no-op: fused regions always compile "
                   "through XLA (the reference's Parakeet role)"))
FLAGS.add(StrFlag("mesh_shape", "", "override mesh shape, e.g. '2x4'"))
FLAGS.add(BoolFlag("multihost", False,
                   "call jax.distributed.initialize() for multi-host SPMD "
                   "(cross-slice DCN; replaces the reference's --hosts)"))
FLAGS.add(BoolFlag("float64_reductions", True,
                   "accumulate reductions in float64 (reference semantics); "
                   "disable for f32 accumulation"))
FLAGS.add(BoolFlag("profile_kernels", False, "time each compiled region"))
FLAGS.add(IntFlag("log_level", 20, "python logging level (10=debug)"))
FLAGS.add(StrFlag("platform", "",
                  "force the jax backend (cpu/gpu) before mesh "
                  "construction; '' = ambient default (JAX_PLATFORMS)"))
FLAGS.add(IntFlag("max_expr_cache", 1024, "max cached compiled regions"))
FLAGS.add(IntFlag("replicate_small_bytes", 65536,
                  "replicate (instead of shard) arrays smaller than this "
                  "many bytes — sharding tiny arrays buys nothing and "
                  "forces gathers/remat in consumers; 0 disables"))
FLAGS.add(BoolFlag("sparse_auto_bsr", True,
                   "auto-detect block structure in sparse matrices and "
                   "route SpMV/SpMM to the block-ELL path (accelerators)"))
FLAGS.add(FloatFlag("sparse_bsr_max_expansion", 16.0,
                    "max stored-elements-per-nonzero the block-ELL repack "
                    "may pay (block tiles are read contiguously, so "
                    "modest expansion still wins over per-element "
                    "gathers)"))
FLAGS.add(BoolFlag("sparse_dense_route", True,
                   "let spmv/spmm densify moderately-dense sparse "
                   "matrices on an accelerator and ride one dense matmul "
                   "(see sparse_dense_min_density/max_bytes)"))
FLAGS.add(FloatFlag("sparse_dense_min_density", 2e-3,
                    "min nnz/(n*m) for the densified SpMM route: below "
                    "this the dense matmul's wasted FLOPs/bandwidth lose "
                    "to the ELL gather"))
FLAGS.add(IntFlag("sparse_dense_max_bytes", 2 << 30,
                  "max f32 bytes (4*n*m) the densified SpMM route may "
                  "materialize on device; larger matrices stay sparse"))
FLAGS.add(FloatFlag("sparse_dense_min_density_spmv", 8e-3,
                    "min density for the densified SpMV route — higher "
                    "than SpMM's because a matvec reuses each matrix "
                    "element once, so the dense read must do less waste"))
FLAGS.add(BoolFlag("sparse_force_dense", False,
                   "route spmm/SpMMExpr AND spmv/SpMVExpr through the "
                   "densified path regardless of platform/density "
                   "— testing/debug"))
FLAGS.add(StrFlag("dot_precision", "default",
                  "matmul precision for float inputs: 'default' = the "
                  "backend's fastest (TF32 tensor cores for f32 on a GPU), "
                  "'high', 'highest' = f32-faithful (the reference's "
                  "numpy-BLAS accuracy); per-call sp.dot(precision=...) "
                  "overrides"))
FLAGS.add(StrFlag("sort_method", "auto",
                  "sort/percentile lowering for sharded 1-D arrays: "
                  "'gather' = all-gather + local sort (XLA's SPMD plan), "
                  "'sample' = distributed sample sort / rank selection, "
                  "'auto' = sample above sort_sample_threshold elements"))
FLAGS.add(IntFlag("sort_sample_threshold", 1 << 22,
                  "element count above which 'auto' sort_method takes the "
                  "distributed sample-sort/selection path (below it the "
                  "gather plan's single collective wins on latency)"))
FLAGS.add(IntFlag("chunk_eval_threshold", 768,
                  "DAGs larger than this (node count) are evaluated in "
                  "segments to keep XLA region compile time linear"))
FLAGS.add(IntFlag("max_fused_kernel_ops", 128,
                  "stop splicing map kernels beyond this op count — XLA "
                  "fuses within the region anyway; unbounded splicing is "
                  "quadratic on long chains"))
FLAGS.add(IntFlag("chunk_eval_size", 256,
                  "segment size (interior ops) for chunked evaluation"))
FLAGS.add(BoolFlag("eager", False, "evaluate every expr immediately (debug)"))
FLAGS.add(IntFlag("linalg_replicate_warn_bytes", 64 << 20,
                  "warn when a dense np.linalg factorization (inv/svd/"
                  "eigh/... — lowered as one whole-operand map) receives "
                  "an operand above this size on a >1-device mesh: XLA "
                  "silently gathers/replicates it per device; the warning "
                  "names the distributed-scale alternative"))
FLAGS.add(IntFlag("linalg_replicate_max_bytes", 0,
                  "if >0, ERROR (instead of warn) when a dense np.linalg "
                  "factorization operand exceeds this size on a "
                  ">1-device mesh — guard for the truly huge case"))
FLAGS.add(IntFlag("fft_pencil_min_elems", 1 << 16,
                  "below this many elements a distributed FFT is cheaper "
                  "replicated than pencil-decomposed (the transpose's "
                  "interconnect round-trip outweighs a <=512 KiB local "
                  "transform)"))
FLAGS.add(BoolFlag("fft_pencil", True,
                   "distribute complex multi-axis FFTs (fft2/ifft2/fftn/"
                   "ifftn) by pencil decomposition on >1-device meshes: "
                   "local FFT over trailing axes, all-to-all reshard, "
                   "local FFT over the leading axis — O(n/p) memory/"
                   "compute per device vs the replicated fallback's O(n). "
                   "Needs both pencil axes divisible by the mesh size; "
                   "falls back otherwise"))
