// The two 16-bit operand types of the tensor-core kernels (the conv3d_k3_*
// and upsample2x* sources that are not _f32): bf16 and fp16. Each kernel is
// a template on its operand type T; this header holds all that differs
// between the two, so the kernels' code is one:
//   b16x2<T>     the pair type of T (16-byte loads are 4 pairs);
//   to_f2(v)     a pair to two floats (exact);
//   pack2<T>     two floats to a pair, rounded to nearest even; fp16 keeps
//                its subnormals (no flush: the sources build without -ftz);
//   mma16816<T>  mma.sync m16n8k16, T operands, fp32 accumulate. bf16 and
//                fp16 share the fragment layout, so ldmatrix (.b16) and
//                cp.async are the same for both.
// The C launchers take the type as an int code (DT_BF16 / DT_F16, and
// DT_F32 in norm_act.cu; ops/_build.py's DTYPE_CODES) and refuse any other.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

enum : int { DT_BF16 = 0, DT_F16 = 1, DT_F32 = 2 };

template <class T>
struct B16Pair;
template <>
struct B16Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct B16Pair<__half> {
  using type = __half2;
};
template <class T>
using b16x2 = typename B16Pair<T>::type;

__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 to_f2(__half2 v) {
  return __half22float2(v);
}

template <class T>
__device__ __forceinline__ b16x2<T> pack2(float a, float b) {
  if constexpr (std::is_same<T, __half>::value)
    return __floats2half2_rn(a, b);
  else
    return __floats2bfloat162_rn(a, b);
}

template <class T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the launcher's body for operand type `code`: F is a generic lambda called
// with a value of T (its type picks the instantiation)
template <class F>
int b16_dispatch(int code, F f) {
  if (code == DT_BF16) return f(__nv_bfloat16());
  if (code == DT_F16) return f(__half());
  return (int)cudaErrorInvalidValue;
}
