"""Checkpoints in the JAX package's on-disk format, with an async save and
an elastic restore (``training/checkpoint.py`` there).

Layout: one directory per step holding one ``.npy`` file per leaf (its key
with "/" spelled "__") and ``manifest.json`` ({key: file, shape, dtype}).
Keys are the "/"-joined tree paths JAX writes (``params/blocks/wq``,
``opt/step``); dtypes are numpy names, and a leaf whose dtype is outside
the list numpy stores natively (bfloat16 among them) is written as float32
with its own dtype in the manifest.  So a step written by either package
restores in the other.  A step is written to ``tmp_{step}`` and renamed to
``step_{step}`` when complete; the ``keep`` latest steps are kept, and a
directory without a manifest is ignored.

Saves run on a background thread.  The device-to-host copy is made before
the thread starts: the optimizer updates its state in place, so a thread
reading device tensors would race the next step.

Fault-tolerance contract used by train_loop: latest complete checkpoint
wins.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training.tree import flatten, unflatten

_NATIVE = ("float32", "float64", "int32", "int64", "uint32", "bool", "int8",
           "uint8", "int16")


def _host(t: torch.Tensor):
    """(a numpy copy of ``t`` as it goes to disk, its numpy dtype name)."""
    name = str(t.dtype).removeprefix("torch.")
    t = t.detach().to("cpu", copy=True)
    if name not in _NATIVE:
        t = t.float()                          # bf16 & friends -> f32
    return t.numpy(), name


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save -------------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        host = {k: _host(v) for k, v in flatten(tree).items()}
        if self._thread is not None:
            self._thread.join()

        def write():
            tmp = self.dir / f"tmp_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {}
            for key, (arr, dtype) in host.items():
                fn = key.replace("/", "__") + ".npy"
                np.save(tmp / fn, arr)
                manifest[key] = dict(file=fn, shape=list(arr.shape),
                                     dtype=dtype)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------------

    def steps(self):
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, devices: Any = None) -> Any:
        """Restore into the structure and dtypes of ``like``.  Each leaf goes
        to the device of ``like``'s leaf, or to the one ``devices`` gives:
        a device for every leaf, or a tree of devices shaped like ``like``
        (elastic: independent of where the step was written).  To place
        parameters on a mesh, shard the result
        (``distributed.sharding.ShardingPlan.shard_params``)."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_like = flatten(like)
        if devices is None or isinstance(devices, (str, torch.device)):
            flat_dev = dict.fromkeys(flat_like, devices)
        else:
            flat_dev = flatten(devices)
        loaded = []
        for key, tgt in flat_like.items():
            arr = np.load(d / manifest[key]["file"])
            dev = flat_dev[key] if flat_dev[key] is not None else tgt.device
            loaded.append(torch.from_numpy(arr).to(device=dev,
                                                   dtype=tgt.dtype))
        return unflatten(like, loaded)
