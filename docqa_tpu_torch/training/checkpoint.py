"""Checkpoint / resume for a training state, counterpart of
``docqa_tpu/training/checkpoint.py`` (whose format is Orbax's; this one is
the port's own).

A state is ``{"params": {name: tensor}, "opt_state": ChainState, "step":
int}`` (``training/train.py``, ``training/encoder.py``).  Each save is one
directory per step, written under a temporary name and then
``os.replace``d, so a crash mid-write leaves no directory that
:meth:`latest_step` would name.  The newest ``max_to_keep`` steps are kept.
Files are read with ``torch.load(weights_only=True)``: tensors and plain
containers only.

* A whole state (no ``opt_state.layout``: a state on one device) is
  ``<step>/state.pt``: the params on the host, the optimizer's
  ``state_dict`` (AdamW moments and update count) and the step.
* A state on a mesh (``init_train_state(mesh=)``,
  ``init_encoder_train_state(mesh=)``: its optimizer state carries a
  ``parallel/sharding.TreeLayout``, replicated leaves and all) is one
  file a rank,
  ``<step>/rank<r>-of-<n>.pt``.  Each holds the manifest (per leaf: global
  shape, the dimension split over the model axis, the mesh's shape), the
  update count and step, and this rank's pieces: per leaf its block of the
  param and of both AdamW moments, with the block's offset.  Ranks at data
  index 0 write their blocks, and a replicated leaf is written once, by
  the rank at model index 0 and data index 0; the other ranks' files hold
  the manifest alone.  Every rank writes into the temporary directory;
  after a barrier over a gloo group the leader (rank 0) renames it, and
  only the leader prunes.  A directory counts once every rank's file is in
  it.

:meth:`TrainCheckpointer.restore` assembles each of the template's blocks
from the saved pieces that overlap it (a whole state's file read as one
whole piece a leaf), so a state saved on one mesh restores on another
mesh or on one device, and a whole state restores on a mesh.  The rank
files are memory-mapped: a rank reads the pieces it needs.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from docqa_tpu_torch.runtime.mesh import barrier
from docqa_tpu_torch.runtime.metrics import get_logger

log = get_logger("docqa.checkpoint")

_FILE = "state.pt"
_RANK_FILE = re.compile(r"rank(\d+)-of-(\d+)\.pt")
_MOMENTS = ("exp_avg", "exp_avg_sq")


def _to_host(obj):
    """A copy of ``obj`` with every tensor cloned to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_files(path: str) -> Tuple[Dict[int, str], int]:
    """{rank: file name} of the save at ``path`` and its world size (0 when
    it holds no rank file)."""
    found, world = {}, 0
    for name in os.listdir(path):
        m = _RANK_FILE.fullmatch(name)
        if m:
            world = int(m.group(2))
            found[int(m.group(1))] = name
    return found, world


def _complete(path: str) -> bool:
    if os.path.exists(os.path.join(path, _FILE)):
        return True
    found, world = _rank_files(path)
    return world > 0 and set(found) == set(range(world))


def _adam_moments(opt_state, params) -> Dict[str, Dict[str, torch.Tensor]]:
    state = opt_state.adamw.state
    return {k: {m: state[p][m] for m in _MOMENTS}
            for k, p in params.items() if p in state}


def _adam_step(opt_state, params) -> Optional[torch.Tensor]:
    state = opt_state.adamw.state
    for p in params.values():
        if p in state:
            return state[p]["step"]
    return None


def _place(target: torch.Tensor, t_dim: Optional[int], t_start: int,
           piece: torch.Tensor, p_dim: Optional[int], p_start: int) -> int:
    """Copy the part of a saved piece that falls in the target block (each
    a block of one global leaf along its split dimension, or the whole
    leaf); returns the elements copied."""
    if p_dim is None and t_dim is None:
        target.copy_(piece)
        return target.numel()
    if p_dim is None:
        target.copy_(piece.narrow(t_dim, t_start, target.shape[t_dim]))
        return target.numel()
    if t_dim is not None and t_dim != p_dim:
        raise ValueError(f"a piece split on dim {p_dim} cannot fill a block split on {t_dim}")
    d = p_dim
    t_start = t_start if t_dim is not None else 0
    lo = max(t_start, p_start)
    hi = min(t_start + target.shape[d], p_start + piece.shape[d])
    if hi <= lo:
        return 0
    part = target.narrow(d, lo - t_start, hi - lo)
    part.copy_(piece.narrow(d, lo - p_start, hi - lo))
    return part.numel()


class TrainCheckpointer:
    """Saves and restores training states under ``directory``.  On a mesh
    every rank makes one, saves the same steps in the same order and may
    restore on its own (the module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None  # the gloo group of a sharded save's barriers

    # ---- API -----------------------------------------------------------------

    def save(self, state: Any, step: Optional[int] = None, wait: bool = True) -> int:
        """Persist the full state; returns the step it was saved as.  The
        host copy is taken before this returns; with ``wait=False`` the
        files are written on a background thread, which the next call
        (or :meth:`close`) waits for.  On a mesh every rank calls it."""
        self.wait_until_finished()
        if step is None:
            step = int(state["step"])
        layout = getattr(state["opt_state"], "layout", None)
        if layout is None:
            payload = _to_host({
                "params": dict(state["params"]),
                "opt_state": state["opt_state"].state_dict(),
                "step": int(state["step"]),
            })
            write = self._write
        else:
            payload = _to_host(self._rank_payload(state, layout))
            if layout.mesh.n_devices > 1 and self._group is None:
                self._group = dist.new_group(backend="gloo")
            write = self._write_sharded
        if wait:
            write(step, payload)
        else:
            self._writer = threading.Thread(
                target=self._write_catching, args=(write, step, payload),
                name="train-checkpoint", daemon=True,
            )
            self._writer.start()
        return step

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into ``template`` (an initialized state, e.g. from
        ``init_train_state``, on one device or on a mesh): its params are
        overwritten in place on their own device and dtype, its optimizer
        state loaded (the moments beside their params) and its step set.
        Returns the template.  Raises ``FileNotFoundError`` when there is no
        checkpoint or a rank's file is missing, ``ValueError`` when the
        saved leaves or their global shapes are not the template's."""
        step = step if step is not None else self.latest_step()
        path = None if step is None else os.path.join(self.directory, str(step))
        if path is None or not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        layout = getattr(template["opt_state"], "layout", None)
        if os.path.exists(os.path.join(path, _FILE)):
            saved = self._whole_as_pieces(torch.load(
                os.path.join(path, _FILE), map_location="cpu", weights_only=True))
        else:
            saved = self._load_pieces(step, path)
        self._assemble(template, layout, saved, step)
        log.info("checkpoint restored from step %d", step)
        return template

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait_until_finished()

    # ---- internals: the step directories ----------------------------------------

    def _steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and _complete(os.path.join(self.directory, name))
        )

    def _write(self, step: int, payload: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        self._write_file(os.path.join(tmp, _FILE), payload)
        self._commit(step, tmp, final)

    def _write_catching(self, write, step: int, payload: dict) -> None:
        try:
            write(step, payload)
        except Exception as e:  # re-raised by the next call
            self._error = e

    @staticmethod
    def _write_file(path: str, payload: dict) -> None:
        with open(path, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())

    def _commit(self, step: int, tmp: str, final: str) -> None:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        log.info("checkpoint saved at step %d -> %s", step, self.directory)

    # ---- internals: rank files, and every restore -------------------------------

    @staticmethod
    def _rank_payload(state: Any, layout) -> dict:
        mesh, params = layout.mesh, state["params"]
        opt = state["opt_state"]
        manifest = {k: {"shape": list(layout.shapes[k]), "dim": layout.dims[k],
                        "mesh": [mesh.n_data, mesh.n_model]} for k in params}
        moments = _adam_moments(opt, params)
        pieces = {}
        if mesh.data_index == 0:
            for k, p in params.items():
                dim, start, _length = layout.block(k)
                if dim is None and mesh.model_index != 0:
                    continue
                pieces[k] = {"dim": dim, "start": start, "param": p.detach(),
                             **moments.get(k, {})}
        return {"manifest": manifest, "pieces": pieces, "count": opt.count,
                "adam_step": _adam_step(opt, params), "step": int(state["step"])}

    def _write_sharded(self, step: int, payload: dict) -> None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp")
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        barrier(self._group, "checkpoint")
        self._write_file(os.path.join(tmp, f"rank{rank}-of-{world}.pt"), payload)
        barrier(self._group, "checkpoint")
        if rank == 0:
            self._commit(step, tmp, final)
        barrier(self._group, "checkpoint")

    @staticmethod
    def _whole_as_pieces(saved: dict) -> dict:
        """A whole state's file in the pieces' form (one whole piece a
        leaf; the AdamW state's indices follow the params' order)."""
        names = list(saved["params"])
        adam = saved["opt_state"]["adamw"]["state"]
        pieces, adam_step = {}, None
        for i, k in enumerate(names):
            pieces[k] = {"dim": None, "start": 0, "param": saved["params"][k]}
            if i in adam:
                pieces[k].update({m: adam[i][m] for m in _MOMENTS})
                adam_step = adam[i]["step"]
        manifest = {k: {"shape": list(v.shape), "dim": None, "mesh": [1, 1]}
                    for k, v in saved["params"].items()}
        return {"manifest": manifest, "files": [{"pieces": pieces}],
                "count": int(saved["opt_state"]["count"]), "adam_step": adam_step,
                "step": int(saved["step"])}

    @staticmethod
    def _load_pieces(step: int, path: str) -> dict:
        found, world = _rank_files(path)
        missing = sorted(set(range(world)) - set(found))
        if not found or missing:
            raise FileNotFoundError(
                f"checkpoint at step {step} in {path} lacks the file of rank "
                f"{missing[0] if missing else 0} (of {world})")
        files = [torch.load(os.path.join(path, found[r]), map_location="cpu",
                            weights_only=True, mmap=True) for r in range(world)]
        head = files[0]
        return {"manifest": head["manifest"], "files": files, "count": head["count"],
                "adam_step": next((f["adam_step"] for f in files
                                   if f["adam_step"] is not None), None),
                "step": head["step"]}

    @staticmethod
    def _assemble(template: Any, layout, saved: dict, step: int) -> None:
        params = template["params"]
        manifest = saved["manifest"]
        if set(manifest) != set(params):
            odd = sorted(set(manifest) ^ set(params))
            raise ValueError(
                f"checkpoint at step {step} holds other params than the template: {odd[:4]}")
        for k, p in params.items():
            want = layout.shapes[k] if layout is not None else tuple(p.shape)
            if tuple(manifest[k]["shape"]) != tuple(want):
                raise ValueError(
                    f"checkpoint at step {step}: leaf {k!r} has global shape "
                    f"{tuple(manifest[k]['shape'])}, the template's is {tuple(want)}")
        with_moments = saved["adam_step"] is not None
        adam_state = {}
        with torch.no_grad():
            for i, (k, p) in enumerate(params.items()):
                dim, start, _length = (layout.block(k) if layout is not None
                                       else (None, 0, 0))
                blocks = {"param": p}
                if with_moments:
                    blocks.update({m: torch.empty_like(p) for m in _MOMENTS})
                for what, target in blocks.items():
                    covered = sum(
                        _place(target, dim, start, f["pieces"][k][what],
                               f["pieces"][k]["dim"], f["pieces"][k]["start"])
                        for f in saved["files"] if k in f["pieces"])
                    if covered != target.numel():
                        raise ValueError(f"checkpoint at step {step} covers {covered} of "
                                         f"{target.numel()} elements of {k!r}'s {what}")
                if with_moments:
                    adam_state[i] = {"step": saved["adam_step"].clone(),
                                     **{m: blocks[m] for m in _MOMENTS}}
        opt = template["opt_state"]
        state_dict = opt.adamw.state_dict()
        state_dict["state"] = adam_state
        opt.adamw.load_state_dict(state_dict)
        opt.count = int(saved["count"])
        template["step"] = int(saved["step"])
