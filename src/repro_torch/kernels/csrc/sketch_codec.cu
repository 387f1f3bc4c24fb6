// Standalone sketch encode and peel kernels for Hopper (sm_90a), one CUDA
// block per sketch block. They serve the geometries the fused wire
// kernels (sketch_wire.cu) do not: the Bloom-filter index, whose bits are
// a global hash of the whole stream's coordinates and cannot be packed
// per block, and bitmap geometries with block_elems % 32 != 0.
//
// sketch_encode_kernel replaces the TPU kernel
// src/repro/kernels/sketch_encode.py:sketch_encode_pallas (body
// _encode_kernel, core encode_tile): the Count-Sketch encode of the
// fused producer without the words and the max.
//
// sketch_peel_kernel replaces src/repro/kernels/sketch_peel.py:
// sketch_peel_pallas (body _peel_kernel, core peel_tile): the fused
// consumer fed one byte per coordinate (a bool or uint8 tensor, read as
// it lies) instead of packed words. The block packs its bytes into
// shared-memory words once, with a ballot per warp over n rounded up to
// 32 (the bits past n stay clear), then runs the same rounds and median.
//
// Both run the code of sketch_tile.cuh that the fused kernels run, so the
// standalone sketch equals the fused producer's, and the standalone peel
// the fused consumer's on the pack_bits of the same bits, bit for bit on
// any input; a run repeats bit for bit (no float atomics).
//
// Bound. Both are bound by device memory. Per block of G*c elements the
// encode reads the block (4Gc bytes) and writes the sketch (4*rows*c):
// 135 KB at G=60, c=512, rows=6. The peel reads the sketch and one byte a
// coordinate and writes values and an int8 residual (4*rows*c + 6Gc
// bytes): 197 KB. Design as sketch_wire.cu: the encode stages the x block
// in shared memory where it fits; the peel keeps y, the degrees, the bits
// and the peeled values there, or y and the degrees in device-memory
// scratch where they do not (the lossless profile, rows=60 at ratio 2).
//
// Interface: plain C, loaded with ctypes; each function returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_tile.cuh"

using namespace sketch_tile;

namespace {

template <bool kResident>
__global__ void __launch_bounds__(kThreads)
sketch_encode_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ ent,
                     const float* __restrict__ ent_sign,
                     float* __restrict__ sketch, int group, int lanes,
                     int rows, uint32_t salt) {
  extern __shared__ float smem[];
  const int n = group * lanes;
  const long long blk = blockIdx.x;
  const float* xb = x + blk * n;
  const float* xs;
  int* rot;
  if constexpr (kResident) {
    xs = smem;
    rot = reinterpret_cast<int*>(smem + n);
    for (int e = threadIdx.x; e < n; e += blockDim.x) smem[e] = xb[e];
  } else {
    xs = xb;
    rot = reinterpret_cast<int*>(smem);
  }
  block_rotations(rot, (uint32_t)ids[blk], group, lanes, salt);
  __syncthreads();
  encode_cells(xs, rot, row_ptr, ent, ent_sign, sketch + blk * rows * lanes,
               1.0f, lanes, rows);
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads)
sketch_peel_kernel(const float* __restrict__ sketch,
                   const uint8_t* __restrict__ bits,
                   const int* __restrict__ ids,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ ent,
                   const float* __restrict__ ent_sign,
                   const int* __restrict__ hrow,
                   const float* __restrict__ sign, float* __restrict__ values,
                   int8_t* __restrict__ residual, float* y_dev, int* d_dev,
                   int group, int lanes, int rows, int rounds,
                   uint32_t salt) {
  extern __shared__ float smem[];
  const int n = group * lanes, nw = (n + 31) / 32, ns = rows * lanes;
  const long long blk = blockIdx.x;
  const uint8_t* bg = bits + blk * n;
  float* vout = values + blk * n;
  const PeelPlanes p =
      peel_planes<kResident>(smem, y_dev, d_dev, vout, blk, n, ns, nw);

  block_rotations(p.rot, (uint32_t)ids[blk], group, lanes, salt);
  for (int e = threadIdx.x; e < ns; e += blockDim.x)
    p.y[e] = sketch[blk * ns + e];
  // blockDim % 32 == 0 and the loop runs to a multiple of 32: every lane
  // of a warp takes part in each ballot.
  for (int e = threadIdx.x; e < nw * 32; e += blockDim.x) {
    const unsigned w = __ballot_sync(0xffffffffu, e < n && bg[e] != 0);
    if ((threadIdx.x & 31) == 0) p.bw[e >> 5] = w;
  }
  __syncthreads();

  peel_block<kResident>(p, row_ptr, ent, ent_sign, hrow, sign, vout,
                        residual + blk * n, ByteBits{bg}, n, lanes, rows,
                        rounds);
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may opt in to on `device`, or a
// negative cudaError_t.
int sketch_codec_max_smem(int device) { return max_smem_optin(device); }

// Dynamic shared memory of each kernel; `resident` keeps the x block (the
// encode) or y, d and the peeled values (the peel) there too.
size_t sketch_codec_encode_smem(int group, int lanes, int resident) {
  return encode_smem(group, lanes, resident);
}

size_t sketch_codec_peel_smem(int group, int lanes, int rows, int resident) {
  return peel_smem(group, lanes, rows, resident);
}

// x (nb, group, lanes) f32 -> sketch (nb, rows, lanes) f32.
int sketch_codec_encode(const float* x, const int* ids, const int* row_ptr,
                        const int* ent, const float* ent_sign, float* sketch,
                        int nb, int group, int lanes, int rows, int resident,
                        unsigned salt, void* stream) {
  const size_t smem = encode_smem(group, lanes, resident);
  const void* fn = resident ? (const void*)sketch_encode_kernel<true>
                            : (const void*)sketch_encode_kernel<false>;
  int err = set_smem(fn, smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (nb > 0) {
    if (resident)
      sketch_encode_kernel<true><<<nb, kThreads, smem, st>>>(
          x, ids, row_ptr, ent, ent_sign, sketch, group, lanes, rows, salt);
    else
      sketch_encode_kernel<false><<<nb, kThreads, smem, st>>>(
          x, ids, row_ptr, ent, ent_sign, sketch, group, lanes, rows, salt);
  }
  return (int)cudaGetLastError();
}

// sketch (nb, rows, lanes) f32 + bits (nb, group, lanes), one byte each,
// non-zero = set -> values (nb, group, lanes) f32, residual int8. y_dev
// (nb, rows, lanes) f32 and d_dev (nb, rows, lanes) int32 are scratch for
// resident == 0 and unused otherwise.
int sketch_codec_peel(const float* sketch, const unsigned char* bits,
                      const int* ids, const int* row_ptr, const int* ent,
                      const float* ent_sign, const int* hrow,
                      const float* sign, float* values, signed char* residual,
                      float* y_dev, int* d_dev, int nb, int group, int lanes,
                      int rows, int rounds, int resident, unsigned salt,
                      void* stream) {
  const size_t smem = peel_smem(group, lanes, rows, resident);
  const void* fn = resident ? (const void*)sketch_peel_kernel<true>
                            : (const void*)sketch_peel_kernel<false>;
  int err = set_smem(fn, smem);
  if (err) return err;
  int8_t* res = reinterpret_cast<int8_t*>(residual);
  cudaStream_t st = (cudaStream_t)stream;
  if (nb > 0) {
    if (resident)
      sketch_peel_kernel<true><<<nb, kThreads, smem, st>>>(
          sketch, bits, ids, row_ptr, ent, ent_sign, hrow, sign, values, res,
          y_dev, d_dev, group, lanes, rows, rounds, salt);
    else
      sketch_peel_kernel<false><<<nb, kThreads, smem, st>>>(
          sketch, bits, ids, row_ptr, ent, ent_sign, hrow, sign, values, res,
          y_dev, d_dev, group, lanes, rows, rounds, salt);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
