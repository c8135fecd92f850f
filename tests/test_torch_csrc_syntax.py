"""The port's CUDA sources as far as a host C++ compiler can check them.

``nvcc`` is not needed: each ``csrc/*.cu`` is parsed by ``g++ -std=c++17
-fsyntax-only`` against the stub ``cuda_runtime.h`` / ``cuda_bf16.h``
below (macros for ``__global__`` and friends, declarations of the
intrinsics the kernels use) with the ``<<<...>>>`` launch configurations
stripped. That instantiates every kernel template an entry point reaches
and so catches type and template errors before the sources meet ``nvcc``.
It says nothing of the device code's behaviour, and inline PTX is only
carried as a string. Add a declaration here when a kernel starts using a
new intrinsic."""
import os
import re
import shutil
import subprocess

import pytest

from nafp_tpu_torch import kernels

CUDA_RUNTIME_H = r"""#pragma once
#include <cstddef>
#include <cstdint>
#include <cmath>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __grid_constant__
#define __launch_bounds__(...)
#define __maxnreg__(...)
#define __align__(n) __attribute__((aligned(n)))
enum cudaError { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef cudaError cudaError_t;
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
extern uint3 threadIdx, blockIdx;
extern dim3 gridDim, blockDim;
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int);
template <class T> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, T*);
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, T, int,
                                                          size_t);
cudaError_t cudaGetLastError();
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct char4 { signed char x, y, z, w; };
int4 make_int4(int, int, int, int);
uint4 make_uint4(unsigned, unsigned, unsigned, unsigned);
float4 make_float4(float, float, float, float);
float2 make_float2(float, float);
void __syncthreads();
void __syncwarp(unsigned m = 0xffffffffu);
template <class T> T __shfl_xor_sync(unsigned, T, int);
template <class T> T __shfl_down_sync(unsigned, T, unsigned);
template <class T> T __shfl_sync(unsigned, T, int);
template <class T> T __shfl_up_sync(unsigned, T, unsigned);
unsigned __ballot_sync(unsigned, int);
int __any_sync(unsigned, int);
int __popc(unsigned);
int __ffs(int);
int atomicAdd(int*, int);
int atomicMax(int*, int);
unsigned atomicMin(unsigned*, unsigned);
int atomicCAS(int*, int, int);
int atomicExch(int*, int);
void __threadfence_block();
int __float_as_int(float);
unsigned __float_as_uint(float);
float __uint_as_float(unsigned);
unsigned __byte_perm(unsigned, unsigned, unsigned);
float __ldcg(const float*);
size_t __cvta_generic_to_shared(const void*);
float __fmul_rn(float, float);
float __fadd_rn(float, float);
float __fsub_rn(float, float);
float __fdiv_rn(float, float);
float __fsqrt_rn(float);
float rsqrtf(float);
float fmaxf(float, float);
int __dp4a(int, int, int);
using std::max;
using std::min;
"""

CUDA_BF16_H = r"""#pragma once
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
__nv_bfloat162 __floats2bfloat162_rn(float, float);
float __bfloat162float(__nv_bfloat16);
__nv_bfloat16 __float2bfloat16_rn(float);
unsigned short __bfloat16_as_ushort(__nv_bfloat16);
"""

SOURCES = sorted(f for f in os.listdir(kernels.CSRC) if f.endswith(".cu"))


@pytest.fixture(scope="module")
def host_tree(tmp_path_factory):
    """csrc/ with the launch configurations stripped, and the stubs."""
    root = tmp_path_factory.mktemp("csrc_host")
    for name in os.listdir(kernels.CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(kernels.CSRC, name)) as f:
                text = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)
            (root / name).write_text(text)
    (root / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (root / "cuda_bf16.h").write_text(CUDA_BF16_H)
    return root


def test_every_kernel_library_is_checked():
    assert SOURCES == sorted(f"{name}.cu" for name in kernels.KERNELS)


@pytest.mark.parametrize("source", SOURCES)
def test_source_parses_as_host_cxx(source, host_tree):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-fsyntax-only",
                        "-I", str(host_tree), str(host_tree / source)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-6000:]
