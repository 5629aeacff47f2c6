#!/usr/bin/env python3
"""Measure the lane-operation rates of fp32 min/max and add on a CUDA card.

    python3 tools/alu_rates.py

Run on a CUDA machine with the CUDA toolkit.  Builds a small kernel with
nvcc (sm_90a) into ``build/alu_rates/`` and times it with CUDA events.
Each thread runs 8 independent chains of inline-PTX ``min.f32`` and
``max.f32`` (kind "minmax"), ``add.f32`` ("add") or ``min.f32`` with
``add.f32`` ("min+add"), 4096 steps of 2 operations each, over 16 blocks
of 256 threads per SM.  Prints one JSON line with the lane operations
per second of each kind, then the card's name, power limit and SM clock.
K1 (``ydorbslam_tpu_torch/csrc/fast_nms.cu``) is mostly min/max; this is
the rate its bound is read against.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r"""
#include <cuda_runtime.h>
template <int KIND>
__global__ void rate_kernel(float* out, int iters, float seed) {
  float a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = seed * (threadIdx.x + i);
    b[i] = seed * (i - 3.5f) + blockIdx.x;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (KIND == 1) {
        asm volatile("add.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(b[i]));
        asm volatile("add.f32 %0, %0, %1;" : "+f"(b[i]) : "f"(a[i]));
      } else {
        asm volatile("min.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(b[i]));
        if (KIND == 0) asm volatile("max.f32 %0, %0, %1;" : "+f"(b[i]) : "f"(a[i]));
        if (KIND == 2) asm volatile("add.f32 %0, %0, %1;" : "+f"(b[i]) : "f"(a[i]));
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += a[i] + b[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rate(int kind, float* out, int blocks, int iters, cudaStream_t stream) {
  if (kind == 0) rate_kernel<0><<<blocks, 256, 0, stream>>>(out, iters, 1e-3f);
  if (kind == 1) rate_kernel<1><<<blocks, 256, 0, stream>>>(out, iters, 1e-3f);
  if (kind == 2) rate_kernel<2><<<blocks, 256, 0, stream>>>(out, iters, 1e-3f);
  return static_cast<int>(cudaGetLastError());
}
"""
ITERS = 4096
OPS_PER_STEP = 16  # 8 chains x 2 operations


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tools/alu_rates.py runs on a GPU")
    sys.path.insert(0, ROOT)
    from ydorbslam_tpu_torch._build import _nvcc

    work = os.path.join(ROOT, "build", "alu_rates")
    os.makedirs(work, exist_ok=True)
    src, lib_path = os.path.join(work, "rates.cu"), os.path.join(work, "librates.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 16 * sms
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for kind, name in ((0, "minmax"), (1, "add"), (2, "min+add")):
        if lib.rate(kind, out.data_ptr(), blocks, ITERS, stream):
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            lib.rate(kind, out.data_ptr(), blocks, ITERS, stream)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        rates[name] = blocks * 256 * ITERS * OPS_PER_STEP / (ms * 1e-3)
    print(json.dumps({"lane_ops_per_s": rates, "sms": sms}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
