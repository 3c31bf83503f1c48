// A yardstick, not a kernel of the port: reads `read_floats` and writes
// `write_floats` float32 values of device memory in 16-byte pieces, on a
// grid-stride loop of 8 blocks of 256 an SM. Each thread issues `loads`
// (1, 2 or 4) float4 loads before its first store, so that many reads are
// in flight at once. Its time is the practical floor of a kernel that
// moves those bytes at that size (launch ramp and tail included);
// chip_smoke.py times B2 beside it.

#include <cuda_runtime.h>

namespace {

template <int LOADS>
__global__ void __launch_bounds__(256)
copy_roof_kernel(const float4* __restrict__ in, long long n_in,
                 float4* __restrict__ out, long long n_out) {
  const long long n = n_in > n_out ? n_in : n_out;
  const long long step = (long long)gridDim.x * 256 * LOADS;
  for (long long base = blockIdx.x * 256LL * LOADS + threadIdx.x; base < n;
       base += step) {
    float4 v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const long long i = base + k * 256LL;
      v[k] = i < n_in ? in[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const long long i = base + k * 256LL;
      if (i < n_out) {
        out[i] = v[k];
      } else if (v[k].x == 1.5f && v[k].y == -2.5f && v[k].z == 3.5f &&
                 v[k].w == -4.5f) {
        out[0] = v[k];   // keeps the reads past n_out alive; never taken
      }
    }
  }
}

}  // namespace

// in: read_floats (a multiple of 4) f32, out: write_floats (a multiple of
// 4) f32, both starting on 16 bytes; loads: float4 loads a thread has in
// flight, 1, 2 or 4. Returns the cudaError_t of the launch.
extern "C" int copy_roof_launch(const float* in, long long read_floats,
                                float* out, long long write_floats,
                                int loads, void* stream) {
  if (read_floats < 0 || write_floats < 1 || (read_floats & 3) ||
      (write_floats & 3) || (loads != 1 && loads != 2 && loads != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const float4* src = reinterpret_cast<const float4*>(in);
  float4* dst = reinterpret_cast<float4*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (loads == 1) {
    copy_roof_kernel<1><<<sms * 8, 256, 0, s>>>(src, read_floats / 4, dst,
                                                write_floats / 4);
  } else if (loads == 2) {
    copy_roof_kernel<2><<<sms * 8, 256, 0, s>>>(src, read_floats / 4, dst,
                                                write_floats / 4);
  } else {
    copy_roof_kernel<4><<<sms * 8, 256, 0, s>>>(src, read_floats / 4, dst,
                                                write_floats / 4);
  }
  return (int)cudaGetLastError();
}
