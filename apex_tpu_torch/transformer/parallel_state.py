"""Model-parallel state over ``torch.distributed``: one process a rank.

Counterpart of ``apex_tpu/transformer/parallel_state.py``, which builds
one JAX mesh with the named axes ``("dp", "pp", "cp", "tp")`` (tp
innermost), or ``("dcn", "ici", "dp", "pp", "cp", "tp")`` with a
hierarchical data extent, and answers rank queries with
``lax.axis_index`` inside ``shard_map``.  The port runs the same program
in every rank's process, so the grid is host arithmetic: the ranks of the
default process group laid out in the mesh's shape (:func:`rank_grid`),
rank ``r`` at the position device ``r`` takes in JAX's
``get_mesh().devices``.  :func:`initialize_model_parallel` keeps JAX's
checks and messages and makes one ``torch.distributed`` group for every
line of every axis (all ranks create all groups, in one order); the rank
getters answer this process's coordinate as a host int, and the group
getters the group of its line.

Before :func:`initialize_model_parallel` (and after
:func:`destroy_model_parallel`) the state is the one-process grid: every
world size is 1, every rank 0 and no group exists, so the layers and the
GPT run at world size 1 without ``torch.distributed`` and issue no
collective.  JAX's getters raise on an uninitialized mesh; these answer
the one-process grid instead, because the port's single-GPU paths run
with no process group at all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "initialize_model_parallel",
    "model_parallel_is_initialized",
    "destroy_model_parallel",
    "get_mesh",
    "rank_grid",
    "RankGrid",
    "spec_axis_names",
    "data_parallel_axis_names",
    "hierarchical_data_parallel_axes",
    "DATA_PARALLEL_AXIS",
    "DATA_PARALLEL_DCN_AXIS",
    "DATA_PARALLEL_ICI_AXIS",
    "PIPELINE_PARALLEL_AXIS",
    "CONTEXT_PARALLEL_AXIS",
    "TENSOR_PARALLEL_AXIS",
    "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_data_parallel_world_size",
    "get_context_parallel_world_size",
    "get_tensor_model_parallel_rank",
    "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank",
    "get_context_parallel_rank",
    "get_tensor_model_parallel_group",
    "get_pipeline_model_parallel_group",
    "get_data_parallel_group",
    "get_context_parallel_group",
    "get_axis_group",
    "is_pipeline_first_stage",
    "is_pipeline_last_stage",
    "is_pipeline_stage_before_split",
    "is_pipeline_stage_after_split",
    "is_pipeline_stage_at_split",
    "get_pipeline_model_parallel_split_rank",
    "get_pipeline_model_parallel_next_rank",
    "get_pipeline_model_parallel_prev_rank",
    "get_virtual_pipeline_model_parallel_world_size",
    "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "get_num_layers",
    "pipeline_stage_layers",
]

DATA_PARALLEL_AXIS = "dp"
PIPELINE_PARALLEL_AXIS = "pp"
CONTEXT_PARALLEL_AXIS = "cp"
TENSOR_PARALLEL_AXIS = "tp"
# the hierarchical data extent (data_parallel_ici_size_): a slow
# inter-slice axis and a fast intra-slice one, "dp" kept at size 1
DATA_PARALLEL_DCN_AXIS = "dcn"
DATA_PARALLEL_ICI_AXIS = "ici"

FLAT_AXES = (DATA_PARALLEL_AXIS, PIPELINE_PARALLEL_AXIS,
             CONTEXT_PARALLEL_AXIS, TENSOR_PARALLEL_AXIS)
HIERARCHICAL_AXES = (DATA_PARALLEL_DCN_AXIS, DATA_PARALLEL_ICI_AXIS) \
    + FLAT_AXES


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """The mesh of ranks: ``devices`` an int array of global ranks in the
    grid's shape, one dim an axis of ``axis_names``; ``shape`` maps each
    axis to its extent, as JAX's ``Mesh.shape`` does."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s coordinate on every axis."""
        pos = np.argwhere(self.devices == rank)
        if len(pos) != 1:
            raise ValueError(f"rank {rank} is not in the grid")
        return dict(zip(self.axis_names, (int(i) for i in pos[0])))

    def lines(self, axis: str) -> List[List[int]]:
        """Every group of ``axis``: the ranks that differ only in their
        coordinate on it, in grid order."""
        i = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, i, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, moved.shape[-1])]


def rank_grid(world: int, tensor_model_parallel_size_: int = 1,
              pipeline_model_parallel_size_: int = 1,
              context_parallel_size_: int = 1, *,
              data_parallel_ici_size_: Optional[int] = None) -> RankGrid:
    """``world`` ranks laid out as JAX lays out ``world`` devices: the
    world must divide by tp * pp * cp, dp is the quotient, and the grid
    is ``arange(world)`` reshaped to ``(dp, pp, cp, tp)``, or to ``(dp /
    ici, ici, 1, pp, cp, tp)`` with a hierarchical data extent (JAX
    ``initialize_model_parallel``, its errors and messages)."""
    tp = tensor_model_parallel_size_
    pp = pipeline_model_parallel_size_
    cp = context_parallel_size_
    denom = tp * pp * cp
    if world % denom != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by "
            f"tensor ({tp}) x pipeline ({pp}) x context ({cp}) parallel sizes"
        )
    dp = world // denom
    ranks = np.arange(world)
    if data_parallel_ici_size_ is not None:
        ici = data_parallel_ici_size_
        if ici < 1 or dp % ici != 0:
            raise RuntimeError(
                f"data extent ({dp}) is not divisible by "
                f"data_parallel_ici_size_ ({ici})"
            )
        return RankGrid(ranks.reshape(dp // ici, ici, 1, pp, cp, tp),
                        HIERARCHICAL_AXES)
    return RankGrid(ranks.reshape(dp, pp, cp, tp), FLAT_AXES)


@dataclasses.dataclass
class _State:
    grid: RankGrid
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, object]


_STATE: Optional[_State] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK: Optional[int] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None
# encoder/decoder boundary for encoder-and-decoder pipelines
_PIPELINE_MODEL_PARALLEL_SPLIT_RANK: Optional[int] = None


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    context_parallel_size_: int = 1,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    *,
    data_parallel_ici_size_: Optional[int] = None,
) -> RankGrid:
    """Lay the default process group's ranks out as JAX's mesh and make
    the groups of every axis; returns the grid.  ``torch.distributed``
    must be initialized (one process a rank; the world is its world
    size).  Every rank calls this with the same arguments."""
    import torch.distributed as dist

    global _STATE, _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK

    if _STATE is not None:
        raise RuntimeError("model parallel is already initialized")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "initialize_model_parallel needs torch.distributed: call "
            "torch.distributed.init_process_group first (one process a "
            "rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    grid = rank_grid(world, tensor_model_parallel_size_,
                     pipeline_model_parallel_size_, context_parallel_size_,
                     data_parallel_ici_size_=data_parallel_ici_size_)
    pp = grid.shape[PIPELINE_PARALLEL_AXIS]

    if virtual_pipeline_model_parallel_size_ is not None:
        if pp <= 2 and virtual_pipeline_model_parallel_size_ > 1:
            raise RuntimeError(
                "pipeline-model-parallel size should be greater than 2 with "
                "interleaved schedule"
            )
        vrank, vworld = 0, virtual_pipeline_model_parallel_size_
    else:
        vrank = vworld = None
    if pipeline_model_parallel_split_rank_ is not None:
        if not 0 < pipeline_model_parallel_split_rank_ < pp:
            raise RuntimeError(
                f"pipeline_model_parallel_split_rank "
                f"({pipeline_model_parallel_split_rank_}) must be inside "
                f"the pipeline (size {pp})"
            )

    # every rank makes every group, axis by axis, in grid order
    groups = {}
    for axis in grid.axis_names:
        for line in grid.lines(axis):
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = vrank
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = vworld
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = pipeline_model_parallel_split_rank_
    _STATE = _State(grid, rank, grid.coords(rank), groups)
    return grid


def spec_axis_names(spec) -> List[str]:
    """The axis names a spec mentions (entries a name, a tuple of names
    or None): which axes shard a leaf."""
    names: List[str] = []
    for entry in spec:
        if isinstance(entry, (tuple, list)):
            names.extend(entry)
        elif entry is not None:
            names.append(entry)
    return names


def model_parallel_is_initialized() -> bool:
    return _STATE is not None


def destroy_model_parallel() -> None:
    """Forget the grid and its groups (the default process group stays:
    ``torch.distributed.destroy_process_group`` is the caller's)."""
    global _STATE, _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    _STATE = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = None


def get_mesh() -> RankGrid:
    if _STATE is None:
        raise RuntimeError(
            "model parallel mesh is not initialized — call "
            "initialize_model_parallel() first"
        )
    return _STATE.grid


# -- world sizes and ranks (host ints) ----------------------------------

def _axis_size(axis: str) -> int:
    return 1 if _STATE is None else _STATE.grid.shape[axis]


def _axis_rank(axis: str) -> int:
    return 0 if _STATE is None else _STATE.coords[axis]


def get_tensor_model_parallel_world_size() -> int:
    return _axis_size(TENSOR_PARALLEL_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _axis_size(PIPELINE_PARALLEL_AXIS)


def hierarchical_data_parallel_axes():
    """``("dcn", "ici")`` for a grid built with
    ``data_parallel_ici_size_``, else None."""
    if _STATE is not None and \
            DATA_PARALLEL_DCN_AXIS in _STATE.grid.axis_names:
        return (DATA_PARALLEL_DCN_AXIS, DATA_PARALLEL_ICI_AXIS)
    return None


def data_parallel_axis_names():
    """The axes the batch shards over: ``("dp",)`` flat, ``("dcn",
    "ici")`` hierarchical."""
    hier = hierarchical_data_parallel_axes()
    return hier if hier is not None else (DATA_PARALLEL_AXIS,)


def get_data_parallel_world_size() -> int:
    size = 1
    for ax in data_parallel_axis_names():
        size *= _axis_size(ax)
    return size


def get_context_parallel_world_size() -> int:
    return _axis_size(CONTEXT_PARALLEL_AXIS)


def get_tensor_model_parallel_rank() -> int:
    return _axis_rank(TENSOR_PARALLEL_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _axis_rank(PIPELINE_PARALLEL_AXIS)


def get_data_parallel_rank() -> int:
    axes = data_parallel_axis_names()
    if len(axes) == 1:
        return _axis_rank(axes[0])
    # hierarchical: the linearized (dcn, ici) rank, dcn-major as the grid
    dcn, ici = axes
    return _axis_rank(dcn) * _axis_size(ici) + _axis_rank(ici)


def get_context_parallel_rank() -> int:
    return _axis_rank(CONTEXT_PARALLEL_AXIS)


# -- groups --------------------------------------------------------------

def get_axis_group(axis: str):
    """This rank's group on ``axis`` (None on the one-process grid)."""
    return None if _STATE is None else _STATE.groups[axis]


def get_tensor_model_parallel_group():
    return get_axis_group(TENSOR_PARALLEL_AXIS)


def get_pipeline_model_parallel_group():
    return get_axis_group(PIPELINE_PARALLEL_AXIS)


def get_data_parallel_group():
    """The flat layout's "dp" group (a hierarchical grid reduces over its
    "dcn" and "ici" groups, :func:`get_axis_group`)."""
    return get_axis_group(DATA_PARALLEL_AXIS)


def get_context_parallel_group():
    return get_axis_group(CONTEXT_PARALLEL_AXIS)


# -- pipeline stage predicates ------------------------------------------

def is_pipeline_first_stage(stage: Optional[int] = None,
                            ignore_virtual: bool = False) -> bool:
    """Whether ``stage`` (default: this rank's) is stage 0; under a
    virtual pipeline only its first model chunk, unless
    ``ignore_virtual``."""
    if not ignore_virtual:
        vrank = get_virtual_pipeline_model_parallel_rank()
        if vrank is not None and vrank != 0:
            return False
    if stage is None:
        stage = get_pipeline_model_parallel_rank()
    return stage == 0


def is_pipeline_last_stage(stage: Optional[int] = None,
                           ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vrank = get_virtual_pipeline_model_parallel_rank()
        vworld = get_virtual_pipeline_model_parallel_world_size()
        if vworld is not None and vrank != vworld - 1:
            return False
    if stage is None:
        stage = get_pipeline_model_parallel_rank()
    return stage == get_pipeline_model_parallel_world_size() - 1


def get_pipeline_model_parallel_next_rank(stage: int) -> int:
    """The next stage's index, wrapping around."""
    return (stage + 1) % get_pipeline_model_parallel_world_size()


def get_pipeline_model_parallel_prev_rank(stage: int) -> int:
    return (stage - 1) % get_pipeline_model_parallel_world_size()


# -- virtual pipeline bookkeeping ---------------------------------------

def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = rank


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    """The encoder/decoder boundary stage, or None."""
    return _PIPELINE_MODEL_PARALLEL_SPLIT_RANK


def is_pipeline_stage_before_split(stage: Optional[int] = None) -> bool:
    """Whether ``stage`` (default: this rank's) is an encoder stage; True
    when no split is set."""
    split = _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    if split is None:
        return True
    if stage is None:
        stage = get_pipeline_model_parallel_rank()
    return stage < split


def is_pipeline_stage_after_split(stage: Optional[int] = None) -> bool:
    split = _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    if split is None:
        return True
    if stage is None:
        stage = get_pipeline_model_parallel_rank()
    return stage >= split


def is_pipeline_stage_at_split(stage: Optional[int] = None) -> bool:
    """Whether ``stage`` is the last encoder stage."""
    split = _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    if split is None:
        return False
    if stage is None:
        stage = get_pipeline_model_parallel_rank()
    return stage == split - 1


def get_num_layers(total_layers: int,
                   is_encoder_and_decoder_model: bool = False,
                   decoder_layers: Optional[int] = None,
                   stage: Optional[int] = None) -> int:
    """Layers one pipeline stage owns (JAX ``get_num_layers``: encoder
    layers over the stages before the split, decoder layers over the
    rest)."""
    pp = get_pipeline_model_parallel_world_size()
    if is_encoder_and_decoder_model:
        split = _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
        if split is None:
            raise RuntimeError(
                "encoder_and_decoder pipelines need "
                "pipeline_model_parallel_split_rank_ at "
                "initialize_model_parallel time"
            )
        dec_layers = (
            decoder_layers if decoder_layers is not None else total_layers
        )
        n_enc_stages, n_dec_stages = split, pp - split
        if total_layers % n_enc_stages:
            raise ValueError(
                f"encoder layers ({total_layers}) must be divisible by the "
                f"number of encoder pipeline stages ({n_enc_stages})"
            )
        if dec_layers % n_dec_stages:
            raise ValueError(
                f"decoder layers ({dec_layers}) must be divisible by the "
                f"number of decoder pipeline stages ({n_dec_stages})"
            )
        if is_pipeline_stage_before_split(stage):
            return total_layers // n_enc_stages
        return dec_layers // n_dec_stages
    if total_layers % pp != 0:
        raise ValueError(
            f"num_layers ({total_layers}) must be divisible by pipeline size ({pp})"
        )
    return total_layers // pp


def pipeline_stage_layers(total_layers: int) -> List[range]:
    """Which layer indices live on each pipeline stage."""
    pp = get_pipeline_model_parallel_world_size()
    per = get_num_layers(total_layers)
    return [range(s * per, (s + 1) * per) for s in range(pp)]
