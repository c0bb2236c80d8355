"""Step checkpoints of the train state (the JAX package's
``utils/checkpoint.py``, with ``torch.save`` in place of Orbax).

Reference behavior: HF Trainer step checkpoints (``save_steps 2000``,
``save_total_limit 1``, run_train.sh:26-29). ``CheckpointManager`` keeps the
JAX package's surface and Orbax's rules: ``maybe_save`` writes the first step
it is given when none is on disk and then every ``save_interval_steps``-th,
``save`` writes any step not yet written, and only the newest
``max_to_keep`` steps stay. A step lands in ``<directory>/<step>/state.pt``:
the student's params, the optimizer state and the step. The teacher is not
part of ``TrainState``, so it is never written. Each step is written into a
temporary directory and renamed into place, so a killed run leaves either
the whole step or none of it.

Over a mesh (``mesh=``, ``specs=`` the trainer's ``param_specs``) a step
still holds the whole state: every rank gathers the params and each
params-shaped subtree of the optimizer state (the AdamW moments, the
accumulated gradients), rank 0 writes, and the ranks meet at a barrier;
a restore reads the whole state on every rank and keeps its shards. The
format does not change, so a run resumes at any world size. The ranks share
the directory (one host, or a shared file system).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from llm_qat_torch.parallel import mesh as pmesh
from llm_qat_torch.training.trainer import TrainState

_FILE = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu") if torch.is_tensor(tree) else tree


def _like(template, loaded, path="state"):
    """``loaded`` on the template's devices, checked against its shapes and
    types."""
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(f"{path}: keys {sorted(loaded)} != template {sorted(template)}")
        return {k: _like(template[k], loaded[k], f"{path}/{k}") for k in template}
    if torch.is_tensor(template):
        if loaded.shape != template.shape or loaded.dtype != template.dtype:
            raise ValueError(f"{path}: {loaded.dtype}{tuple(loaded.shape)} != template "
                             f"{template.dtype}{tuple(template.shape)}")
        return loaded.to(template.device)
    return loaded


def _param_trees(fn, tree, keys):
    """``fn`` on every subtree of ``tree`` whose keys are the params' (the
    moments and gradient buffers in an optimizer state)."""
    if isinstance(tree, dict):
        if set(tree) == keys:
            return fn(tree)
        return {k: _param_trees(fn, v, keys) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """Save / restore ``TrainState`` step checkpoints under ``directory``
    (``mesh``, ``specs``: see the module's docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 1, save_interval_steps: int = 2000,
                 mesh=None, specs=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.mesh, self.specs = mesh, specs
        os.makedirs(self.directory, exist_ok=True)

    def _whole(self, state: TrainState):
        """(params, opt_state) whole on the CPU (a collective under a mesh)."""
        if self.mesh is None:
            return _to_cpu(state.params), _to_cpu(state.opt_state)
        whole = lambda t: _to_cpu(pmesh.gather_params(t, self.mesh, self.specs))  # noqa: E731
        return whole(state.params), _param_trees(whole, state.opt_state, set(state.params))

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, _FILE)))

    def maybe_save(self, step: int, state: TrainState) -> bool:
        """Save if no step is on disk yet or the step hits the interval."""
        steps = self.all_steps()
        if step in steps or (steps and step % self.save_interval_steps):
            return False
        return self._write(step, state)

    def save(self, step: int, state: TrainState) -> bool:
        if step in self.all_steps():
            return False  # interval save already wrote this step
        return self._write(step, state)

    def _write(self, step: int, state: TrainState) -> bool:
        params, opt_state = self._whole(state)
        if self.mesh is None or dist.get_rank() == 0:
            final = os.path.join(self.directory, str(step))
            tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"params": params, "opt_state": opt_state, "step": int(state.step)},
                       os.path.join(tmp, _FILE))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        if self.mesh is not None:
            dist.barrier()   # no rank lists the directory before the write lands
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore into the template's shapes, types and devices."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = torch.load(os.path.join(self.directory, str(step), _FILE), map_location="cpu",
                       weights_only=True)
        params, opt_state = d["params"], d["opt_state"]
        if self.mesh is not None:
            mine = lambda t: pmesh.shard_params(t, self.mesh, self.specs)  # noqa: E731
            params, opt_state = mine(params), _param_trees(mine, opt_state, set(params))
        return TrainState(_like(state_template.params, params, "params"),
                          _like(state_template.opt_state, opt_state, "opt_state"),
                          d["step"])

    def wait(self):
        """Writes are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open."""
