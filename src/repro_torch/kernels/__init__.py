"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and the
device dispatch.

rmsnorm          — fused row norm and its backward, dx and a fixed-order
                   dscale (``csrc/rmsnorm.cu``)
flash_attention  — online-softmax attention forward, causal/window/GQA; bf16
                   on the tensor cores (``csrc/flash_attention.cu``), and its
                   backward, dq/dk/dv from the forward's lse, no atomics
                   (``csrc/flash_attention_bwd.cu``)
decode_attention — single-token split-K flash-decode over (ring) KV caches
                   (``csrc/decode_attention.cu``)
ssm_scan         — chunked Mamba-2 SSD scan, chunk-parallel passes
                   (``csrc/ssm_scan.cu``), and its backward, dx/da/db/dc/dh0
                   from the forward's workspace, no atomics
                   (``csrc/ssm_scan_bwd.cu``)
dp_sweep         — the placement path's batched f64 min-plus DP sweep
                   (``csrc/dp_sweep.cu``)
ref, chunked     — the plain versions (``chunked`` holds the SSD scan's and
                   the chunked mLSTM, ``ref`` the sequential oracles and the
                   norm's autograd backward); ops — dispatch by device
build            — nvcc at first use into ``_build/``, loaded with ctypes
"""

from . import ops, ref

__all__ = ["ops", "ref"]
