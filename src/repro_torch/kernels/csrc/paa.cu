// K2 paa: segment means [N, n] -> [N, l] f32, n % l == 0.
//
// Replaces src/repro/kernels/paa.py (paa_pallas / _paa_kernel), the
// iSAX build's summary of the whole collection and of every query batch.
// Bound on the H100: bytes (each input float is read once and used in
// one add). One thread owns one (row, segment) pair and sums its w
// contiguous floats left to right, then scales the sum by the float32
// reciprocal of w the wrapper passes in: the arithmetic of the plain
// version (kernels/ref.py ref_paa), so the two agree bit for bit and the
// iSAX codes do not depend on where PAA ran. Consecutive
// threads own consecutive segments of consecutive rows, so a warp walks
// one contiguous stretch of memory; the float4 path reads 16 bytes a
// thread when the rows allow it.
#include "common.cuh"

__global__ void __launch_bounds__(256)
paa_kernel(const float* __restrict__ x, float* __restrict__ out,
           long long n_out, int n, int l, int w, float inv_w, bool vec4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const long long row = idx / l;
  const int seg = (int)(idx - row * l);
  const float* p = x + row * (long long)n + (long long)seg * w;
  float acc = 0.f;
  if (vec4) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (int j = 0; j < w / 4; ++j) {
      const float4 v = __ldg(p4 + j);
      acc = acc + v.x;
      acc = acc + v.y;
      acc = acc + v.z;
      acc = acc + v.w;
    }
  } else {
    for (int j = 0; j < w; ++j) acc = acc + __ldg(p + j);
  }
  out[idx] = acc * inv_w;
}

extern "C" int paa_f32(const void* x, void* out, long long n_rows, int n,
                       int l, float inv_w, void* stream) {
  const int w = n / l;
  const long long n_out = n_rows * l;
  if (n_out == 0) return 0;
  const bool vec4 = (w % 4 == 0) && rt::aligned16(x);
  const int threads = 256;
  const long long blocks = (n_out + threads - 1) / threads;
  paa_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n_out, n, l,
      w, inv_w, vec4);
  return (int)cudaGetLastError();
}
