"""Hash-chained async checkpoints (port of repro.checkpoint.checkpointer):
the fabric block store applied to training state.

Blocks are immutable and stored off the critical path by a storage role;
the in-memory world state is safe because the chain can rebuild it. Here
the training world state (params, optimizer, ledger head) is copied to the
host at ``save`` and written by a writer thread; every checkpoint carries
  * a content digest per leaf (FNV-1a over raw bytes),
  * a chain hash H(prev_chain, step, leaf digests): checkpoint N commits to
    the whole history,
  * the train-ledger head (training/train_step.py).

Files are the JAX package's: ``step_XXXXXXXX/arrays.npz`` (``leaf_i``, in
the JAX flatten order of ``TrainState``: params, ``opt.step``, ``opt.m``,
``opt.v``, ``ledger_head``, per-layer leaves stacked on a leading layer
axis) and ``manifest.json``, published by one atomic rename; the newest
``keep`` are kept. So each package restores the other's directories. A
bf16 leaf is written as f32, which holds it exactly, with ``"bfloat16"``
in ``dtypes``: the JAX package's restore (``astype`` to the leaf's dtype)
reads it back bit for bit, where it would read raw 16-bit words as
integers. The port also restores a bf16 leaf saved as 16-bit words: the
JAX package's own bf16 files (numpy keeps them as 2-byte voids, which the
JAX restore cannot cast) and the port's older ones (uint16). The leaves
the model keeps f32 (``models.lm.F32_LEAVES``) and the moments stay f32.

``restore`` writes into the tensors of the state it is given (the model
holds the params), where the JAX package returns new arrays.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.training.train_step import TrainState, state_leaves

_FNV_OFF = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def _digest_bytes(buf: bytes) -> int:
    """FNV-1a over 8-byte strides (vectorized)."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    pad = (-len(arr)) % 8
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
    words = arr.view(np.uint64)
    mask = (1 << 64) - 1
    prime = int(_FNV_PRIME)
    h = int(_FNV_OFF)
    # Chunked horner over 64-bit words keeps this O(n) in numpy.
    for chunk in np.array_split(words, max(1, len(words) // 65536)):
        for w in chunk[:: max(1, len(chunk) // 64)]:  # strided sample
            h = ((h ^ int(w)) * prime) & mask
        h = (h ^ (len(chunk) * prime)) & mask
    return h


def _chain(prev: int, step: int, digests: list[int]) -> int:
    mask = (1 << 64) - 1
    h = (prev ^ (step * int(_FNV_PRIME))) & mask
    for d in digests:
        h = ((h ^ d) * int(_FNV_PRIME)) & mask
    return h


def _to_host(group: list[torch.Tensor], u32_words: bool) -> np.ndarray:
    """One JAX leaf as numpy: a group of one tensor as it is, of several
    stacked; bf16 as f32 (exact), u32 words as uint32."""
    t = (group[0].detach().to("cpu", copy=True) if len(group) == 1 else
         torch.stack([x.detach() for x in group]).cpu())  # a copy: the
    # state changes in place while the writer thread hashes
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return u32.to_numpy(t) if u32_words else t.numpy()


def _to_tensor(arr: np.ndarray, dtype_name: str, like: torch.Tensor
               ) -> torch.Tensor:
    """A saved leaf (or one layer of it) as a CPU tensor of ``like``'s
    dtype: bf16 saved as 16-bit words reinterpreted, anything else (bf16
    saved as f32 included) converted."""
    if dtype_name == "bfloat16" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    elif arr.dtype == np.uint32:  # u32 words
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(like.dtype)


class Checkpointer:
    """Async writer (storage role) + restorer."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[Exception] = None
        self._t = threading.Thread(target=self._writer, daemon=True)
        self._t.start()

    # ------------------------------------------------------------- save path

    def save(self, step: int, state: TrainState, *,
             blocking: bool = False) -> None:
        """Copy the state to the host now; hash and write off-thread."""
        groups = state_leaves(state)
        head = len(groups) - 1  # the ledger head's words are u32
        host = [_to_host(g, i == head) for i, g in enumerate(groups)]
        dtypes = ["bfloat16" if g[0].dtype == torch.bfloat16 else
                  str(a.dtype) for g, a in zip(groups, host)]
        self._q.put((step, host, dtypes))
        if blocking:
            self.wait()

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def _writer(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except Exception as e:  # raised to the caller by wait/close
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host: list, dtypes: list) -> None:
        prev = self._latest_manifest()
        prev_chain = prev["chain"] if prev else 0
        digests = [_digest_bytes(a.tobytes()) for a in host]
        chain = _chain(prev_chain, step, digests)
        tmp = os.path.join(self.dir, f".tmp_step_{step:08d}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "chain": chain,
            "prev_chain": prev_chain,
            "digests": digests,
            "treedef": "TrainState(params, AdamWState(step, m, v), "
                       "ledger_head) in the JAX flatten order",
            "shapes": [list(a.shape) for a in host],
            "dtypes": dtypes,
            "time": time.time(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore path

    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def _latest_manifest(self) -> Optional[dict]:
        steps = self.list_steps()
        if not steps:
            return None
        with open(os.path.join(
                self.dir, f"step_{steps[-1]:08d}", "manifest.json")) as f:
            return json.load(f)

    @torch.no_grad()
    def restore(self, like: TrainState, *, step: Optional[int] = None,
                verify: bool = True) -> tuple[TrainState, int]:
        """Load checkpoint ``step`` (the newest by default) into ``like``,
        every leaf copied into its tensor on its device; returns (like,
        step)."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = steps[-1] if step is None else step
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            host = [data[f"leaf_{i}"] for i in range(len(data.files))]
        if verify:
            digests = [_digest_bytes(a.tobytes()) for a in host]
            if digests != manifest["digests"]:
                raise ValueError(f"checkpoint {step}: digest mismatch "
                                 "(corrupt or tampered)")
        groups = state_leaves(like)
        if len(groups) != len(host):
            raise ValueError(
                f"checkpoint {step} has {len(host)} leaves, expected "
                f"{len(groups)} (architecture mismatch)")
        dtypes = manifest.get("dtypes", [str(a.dtype) for a in host])
        for group, arr, dt in zip(groups, host, dtypes):
            parts = [arr] if len(group) == 1 else list(arr)
            if len(parts) != len(group):
                raise ValueError(f"checkpoint {step}: a stacked leaf of "
                                 f"{len(parts)} layers, expected "
                                 f"{len(group)}")
            for t, a in zip(group, parts):
                t.copy_(_to_tensor(a, dt, t).reshape(t.shape))
        return like, step

    def verify_chain(self) -> bool:
        """Walk every retained checkpoint and re-derive the chain."""
        prev = None
        for s in self.list_steps():
            with open(os.path.join(
                    self.dir, f"step_{s:08d}", "manifest.json")) as f:
                m = json.load(f)
            if prev is not None and m["prev_chain"] != prev:
                return False
            if _chain(m["prev_chain"], m["step"], m["digests"]) != m["chain"]:
                return False
            prev = m["chain"]
        return True

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
