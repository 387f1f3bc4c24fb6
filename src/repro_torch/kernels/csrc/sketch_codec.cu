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
// shared-memory words once, from two 16-byte loads a word where n % 32 ==
// 0 and otherwise with a ballot per warp over n rounded up to 32 (the
// bits past n stay clear), then runs the same rounds and median.
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
// bytes): 197 KB. Design as sketch_wire.cu: the encode streams the x
// block through the shared-memory ring of sketch_tile.cuh:encode_block
// (50,924 B a block at the default geometry, four 256-thread blocks an
// SM); the peel keeps its per-cell state in
// shared memory (three blocks an SM at the default geometry), or in
// device-memory scratch where it does not fit (the lossless profile,
// rows=60 at ratio 2), and stops each block at its own fixpoint: at the
// Bloom index's 0.2% of candidates that is two or three rounds, not
// `rounds`.
//
// Interface: plain C, loaded with ctypes; each function returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_tile.cuh"

using namespace sketch_tile;

namespace {

// The encode: the fused producer's streamed owner-sum
// (sketch_tile::encode_block) without the words and the max.
template <int kRegRows>
__global__ void __launch_bounds__(kEncMaxThreads, kEncMinBlocks)
sketch_encode_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                     const int* __restrict__ cptr, const int* __restrict__ ent,
                     const float* __restrict__ ent_sign,
                     float* __restrict__ sketch,
                     long long* __restrict__ phase, float* plane, int group,
                     int lanes, int rows, int chunk_rows, uint32_t salt) {
  extern __shared__ __align__(16) unsigned char enc_smem[];
  const long long blk = blockIdx.x;
  encode_block<kRegRows>(enc_smem, x, blk, (uint32_t)ids[blk], cptr, ent,
                         ent_sign, sketch, nullptr, nullptr, 1.0f, plane,
                         phase, EncodeShape(group, lanes, rows, chunk_rows,
                                            false),
                         salt);
}

const void* encode_kernel_of(int lanes, int rows) {
  return encode_reg_rows(lanes, rows) ? (const void*)sketch_encode_kernel<8>
                                      : (const void*)sketch_encode_kernel<0>;
}

// The input bits' nonzero bytes as a mask: bit k for byte k of x.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t hi = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ((hi >> 7) & 1u) | ((hi >> 14) & 2u) | ((hi >> 21) & 4u) |
         ((hi >> 28) & 8u);
}

template <bool kResident>
__global__ void __launch_bounds__(kPeelThreads, kPeelBlocksPerSM)
sketch_peel_kernel(const float* __restrict__ sketch,
                   const uint8_t* __restrict__ bits,
                   const int* __restrict__ ids,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ ent, const int* __restrict__ hrow,
                   const float* __restrict__ sign, float* __restrict__ values,
                   int8_t* __restrict__ residual,
                   int* __restrict__ block_rounds, float* state, int group,
                   int lanes, int rows, int rounds, uint32_t salt) {
  extern __shared__ float smem[];
  const int n = group * lanes, nw = (n + 31) / 32, ns = rows * lanes;
  const long long blk = blockIdx.x;
  const uint8_t* bg = bits + blk * n;
  const PeelPlanes p =
      peel_setup<kResident>(smem, state, blk, (uint32_t)ids[blk], row_ptr,
                            ent, hrow, sign, group, lanes, rows, salt);
  load_sketch(p.y, sketch + blk * ns, ns, 1.0f);
  if ((n & 31) == 0 && (reinterpret_cast<uintptr_t>(bg) & 15) == 0) {
    // a word from 32 bytes, two 16-byte loads
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      const uint4 a = reinterpret_cast<const uint4*>(bg)[2 * w];
      const uint4 b = reinterpret_cast<const uint4*>(bg)[2 * w + 1];
      p.org[w] = p.bw[w] =
          nonzero_bytes(a.x) | nonzero_bytes(a.y) << 4 |
          nonzero_bytes(a.z) << 8 | nonzero_bytes(a.w) << 12 |
          nonzero_bytes(b.x) << 16 | nonzero_bytes(b.y) << 20 |
          nonzero_bytes(b.z) << 24 | nonzero_bytes(b.w) << 28;
    }
  } else {
    // blockDim % 32 == 0 and the loop runs to a multiple of 32: every lane
    // of a warp takes part in each ballot.
    for (int e = threadIdx.x; e < nw * 32; e += blockDim.x) {
      const unsigned w = __ballot_sync(0xffffffffu, e < n && bg[e] != 0);
      if ((threadIdx.x & 31) == 0) p.org[e >> 5] = p.bw[e >> 5] = w;
    }
  }
  __syncthreads();

  const int done =
      peel_block(p, values + blk * n, residual + blk * n, n, lanes, rows, rounds);
  if (block_rounds != nullptr && threadIdx.x == 0) block_rounds[blk] = done;
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may opt in to on `device`, or a
// negative cudaError_t.
int sketch_codec_max_smem(int device) { return max_smem_optin(device); }

// Dynamic shared memory of each kernel; `resident` keeps the encode's
// accumulator plane (its plane variant, many rows or lanes) or the peel's
// y, degrees and contributions there too.
size_t sketch_codec_encode_smem(int group, int lanes, int rows, int chunk_rows,
                                int resident) {
  return encode_smem(group, lanes, rows, chunk_rows, resident);
}

size_t sketch_codec_peel_smem(int group, int lanes, int rows, int resident) {
  return peel_smem(group, lanes, rows, resident);
}

// Threads of a block of kernel `kind` (0 the encode, 1 the peel) at
// `lanes`.
int sketch_codec_threads(int kind, int lanes) {
  return kind == 0 ? encode_threads(lanes) : kPeelThreads;
}

// Blocks of kernel `kind` (0 the encode, 1 the peel) that one SM of the
// current device holds at once at this geometry, or a negative cudaError_t.
int sketch_codec_occupancy(int kind, int group, int lanes, int rows,
                           int chunk_rows, int resident) {
  if (kind == 0)
    return occupancy(encode_kernel_of(lanes, rows), encode_threads(lanes),
                     encode_smem(group, lanes, rows, chunk_rows, resident));
  return occupancy(resident ? (const void*)sketch_peel_kernel<true>
                            : (const void*)sketch_peel_kernel<false>,
                   kPeelThreads, peel_smem(group, lanes, rows, resident));
}

// x (nb, group, lanes) f32 -> sketch (nb, rows, lanes) f32. cptr/ent/
// ent_sign list the pairs per (chunk of chunk_rows batch rows, sketch
// row); phase is NULL or (nb, 3) int64; plane is NULL or, where the plane
// variant's plane does not fit shared memory, (nb, rows, lanes) f32
// scratch.
int sketch_codec_encode(const float* x, const int* ids, const int* cptr,
                        const int* ent, const float* ent_sign, float* sketch,
                        long long* phase, float* plane, int nb, int group,
                        int lanes, int rows, int chunk_rows, unsigned salt,
                        void* stream) {
  const size_t smem =
      encode_smem(group, lanes, rows, chunk_rows, plane == nullptr);
  int err = set_smem(encode_kernel_of(lanes, rows), smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (nb > 0) {
    const int threads = encode_threads(lanes);
#define SKETCH_CODEC_ENCODE(R)                                           \
  sketch_encode_kernel<R><<<nb, threads, smem, st>>>(                    \
      x, ids, cptr, ent, ent_sign, sketch, phase, plane, group, lanes,   \
      rows, chunk_rows, salt)
    if (encode_reg_rows(lanes, rows)) SKETCH_CODEC_ENCODE(8);
    else SKETCH_CODEC_ENCODE(0);
#undef SKETCH_CODEC_ENCODE
  }
  return (int)cudaGetLastError();
}

// sketch (nb, rows, lanes) f32 + bits (nb, group, lanes), one byte each,
// non-zero = set -> values (nb, group, lanes) f32, residual int8. state
// (nb, 4, rows, lanes) f32 is scratch for resident == 0 and unused
// otherwise; block_rounds is NULL or (nb,) int32, each block's rounds run.
int sketch_codec_peel(const float* sketch, const unsigned char* bits,
                      const int* ids, const int* row_ptr, const int* ent,
                      const int* hrow, const float* sign, float* values,
                      signed char* residual, int* block_rounds, float* state,
                      int nb, int group, int lanes, int rows, int rounds,
                      int resident, unsigned salt, void* stream) {
  const size_t smem = peel_smem(group, lanes, rows, resident);
  const void* fn = resident ? (const void*)sketch_peel_kernel<true>
                            : (const void*)sketch_peel_kernel<false>;
  int err = set_smem(fn, smem);
  if (err) return err;
  int8_t* res = reinterpret_cast<int8_t*>(residual);
  cudaStream_t st = (cudaStream_t)stream;
  if (nb > 0) {
    if (resident)
      sketch_peel_kernel<true><<<nb, kPeelThreads, smem, st>>>(
          sketch, bits, ids, row_ptr, ent, hrow, sign, values, res,
          block_rounds, state, group, lanes, rows, rounds, salt);
    else
      sketch_peel_kernel<false><<<nb, kPeelThreads, smem, st>>>(
          sketch, bits, ids, row_ptr, ent, hrow, sign, values, res,
          block_rounds, state, group, lanes, rows, rounds, salt);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
