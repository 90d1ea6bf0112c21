"""Wrapper of the MVCC validation kernel (``csrc/mvcc_validate.cu``).

A CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``ref.py``; there is no fallback between them. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import u32
from repro_torch.kernels import build
from repro_torch.kernels.mvcc_validate import ref

MAX_TXS = 1024  # 32 chunks of 32: one warp lane per chunk in the scan
launches = 0


def smem_bytes(b: int, nr: int, nw: int) -> int:
    """Dynamic shared memory of one block's launch on the card: the keys,
    the conflict words (one per (chunk, tx)) and the ok words."""
    f = build.libraries()["mvcc_validate"].mvcc_validate_smem
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_longlong
    return f(b, nr, nw)


def validate(read_keys, read_vers, write_keys, current_versions, ok0):
    """One block: (B,RK,2),(B,RK),(B,WK,2),(B,RK),(B,) bool -> (B,) bool."""
    global launches
    dev = read_keys.device
    b, nr, _ = read_keys.shape
    nw = write_keys.shape[1]
    build.check("read_keys", read_keys, u32.WORD, (b, nr, 2), dev)
    build.check("read_vers", read_vers, u32.WORD, (b, nr), dev)
    build.check("write_keys", write_keys, u32.WORD, (b, nw, 2), dev)
    build.check("current_versions", current_versions, u32.WORD, (b, nr), dev)
    build.check("ok0", ok0, torch.bool, (b,), dev)
    if not build.dispatch(dev):
        return ref.validate_ref(read_keys, read_vers, write_keys,
                                current_versions, ok0)
    if b > MAX_TXS:
        raise ValueError(f"block of {b} txs: the kernel takes at most "
                         f"{MAX_TXS}")
    smem = smem_bytes(b, nr, nw)
    most = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > most:
        raise ValueError(
            f"block of {b} txs with {nr} read and {nw} write keys needs "
            f"{smem} bytes of shared memory; a thread block on "
            f"{torch.cuda.get_device_name(dev)} has at most {most} "
            f"({most // 1024} KB)")
    valid = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return valid
    f = build.c_function("mvcc_validate", "mvcc_validate", 6, 4)
    build.launch(f, "mvcc_validate", dev, read_keys.data_ptr(),
                 read_vers.data_ptr(), write_keys.data_ptr(),
                 current_versions.data_ptr(), ok0.data_ptr(),
                 valid.data_ptr(), 1, b, nr, nw)
    launches += 1
    return valid
