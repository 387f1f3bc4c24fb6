// Fused wire-codec kernels for Hopper (sm_90a): the producer and the
// consumer of the compressed gradient wire, one CUDA block per sketch
// block.
//
// Producer, wire_encode_kernel, replaces the TPU kernel
// src/repro/kernels/sketch_wire.py:encode_pack_quantize_pallas (body
// _wire_encode_kernel). One pass over the gradient block: Count-Sketch
// encode, non-zero bitmap pack, per-block max|sketch|. Its quantize leg
// (TS = int, body _wire_encode_q_kernel) stores the fxp32 wire's
// int32(rint(acc * 2^(M - e))) for the block's exponent e instead of the
// f32 cell; maxabs stays the f32 max|acc|.
//
// Consumer, wire_peel_kernel, replaces
// src/repro/kernels/sketch_wire.py:dequant_peel_unpack_pallas (body
// _wire_peel_kernel). One pass over the aggregated wire payload: bitmap
// unpack, initial degrees, synchronous peel rounds until the block's
// fixpoint (at most `rounds`; the reference always runs `rounds`, and
// rounds after the fixpoint change nothing), and the median-of-3
// estimate for bits still set. Its dequant leg (TS = int,
// body _wire_peel_dq_kernel) loads the int32 aggregate as
// float(q) * 2^(e - M) where the f32 leg loads y.
//
// The legs' scales are exact powers of two written into the exponent
// field (pow2f), never exp2f/ldexpf, and the conversions round half to
// even (__float2int_rn, __int2float_rn), as rint and the int-to-float
// cast do: the quantize leg equals "f32 leg, then FixedPointWire.encode"
// and the dequant leg "FixedPointWire.decode, then f32 leg" bit for bit
// on any input. Each adds one multiply and one conversion per sketch
// cell and 4 bytes of exponent per block, so the bounds below hold.
//
// Bound. Both are bound by device memory. Per block of G*c elements the
// producer reads the block (4Gc bytes) and writes the sketch, the words
// and one float (4*rows*c + Gc/8 + 4 bytes): 139 KB at G=60, c=512,
// rows=6. The consumer reads the sketch and the words and writes values
// and an int8 residual (5Gc bytes): 170 KB. The arithmetic is ~3Gc adds
// per pass, about 100 times below the bytes at the card's rates.
//
// Design. The producer (sketch_tile.cuh:encode_block) streams the x
// block through a ring of three shared-memory stages of chunk_rows batch
// rows (8 rows, 16 KiB at c=512), filled by 16-byte cp.async, two chunks
// in flight while one is summed, so device memory sees each input byte
// once and the shared memory a block needs no longer grows with G:
// 50,924 B at G=60, c=512, rows=6, four 256-thread blocks (32 warps) an
// SM. Each landed chunk gives its words by ballots, a warp four words at
// a time, stored to device memory as they complete; each owner thread
// keeps two columns of every sketch row in registers and adds the
// chunk's terms row by row from per-(chunk, row) lists of the (i, j)
// pairs, staged once a block with their rotations and signs, 8 bytes a
// pair. More than 8 rows (the lossless profile, rows=60) take a second
// instance that keeps the cells in a plane, one column an owner thread:
// in shared memory where it fits, else in device-memory scratch.
// The consumer keeps what its rounds touch in shared memory, 63,580
// B a block at G=60, c=512, rows=6, so three 512-thread blocks (48 warps)
// share an SM and one block's loads and stores overlap another's rounds:
// y, the degrees, this round's per-cell contribution count and single
// value, the input, current and just-peeled bits, the rotations and the
// hash tables. Peeled values go straight to the output plane, where the
// rounds read them back (L2), instead of a 120 KiB shared plane. Its work
// follows the set bits, not the block: degrees start from integer atomics
// over the set bits, the gather walks words and their set bits, the
// scatter visits only the cells a peel touched, and each block stops at
// its own fixpoint (sketch_tile.cuh:peel_block). A geometry whose state
// does not fit shared memory (the lossless profile, rows=60 at ratio 2:
// ~487 KiB for the consumer) runs the same code with the per-cell planes
// in device-memory scratch. Every sketch cell (r, m) sums its
// contributions in the reference's (i, j) order from 0.0 (the producer's
// owner thread over a row's lists, chunk after chunk; the consumer's
// owner where one value arrives, a warp over the row's list where several
// do). There are no float atomics, so a run repeats bit for bit, and on
// dyadic inputs the result equals the plain version's exactly. The
// bitmap word w, bit k is element 32w+k of the block: one __ballot_sync
// per warp over 32 consecutive elements.
//
// The owner-sum encode and the peel rounds live in sketch_tile.cuh, shared
// with the standalone encode and peel of sketch_codec.cu. The TPU kernels'
// one-hot plan-matrix contraction, VMEM budgets and multi-block grid cells
// are not carried over.
//
// Interface: plain C, loaded with ctypes. Each function returns the
// cudaError_t of the launch (0 on success). Words are uint32 bits (the
// PyTorch side stores them in int32 tensors).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sketch_tile.cuh"

using namespace sketch_tile;

namespace {

// The producer: one block a sketch block, encode_threads(lanes) threads,
// the streamed owner-sum of sketch_tile::encode_block with the words and
// the max. TS is the sketch's wire type: float, or int for the quantize
// leg (exps and mbits are read only then, once a block). kRegRows as in
// encode_block; plane is NULL or the plane variant's device scratch.
template <int kRegRows, typename TS>
__global__ void __launch_bounds__(kEncMaxThreads, kEncMinBlocks)
wire_encode_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                   const int* __restrict__ cptr, const int* __restrict__ ent,
                   const float* __restrict__ ent_sign,
                   TS* __restrict__ sketch, uint32_t* __restrict__ words,
                   float* __restrict__ maxabs, const int* __restrict__ exps,
                   long long* __restrict__ phase, float* plane, int mbits,
                   int group, int lanes, int rows, int chunk_rows,
                   uint32_t salt) {
  extern __shared__ __align__(16) unsigned char enc_smem[];
  const long long blk = blockIdx.x;
  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(mbits - exps[blk]);
  encode_block<kRegRows>(enc_smem, x, blk, (uint32_t)ids[blk], cptr, ent,
                         ent_sign, sketch, words, maxabs, s, plane, phase,
                         EncodeShape(group, lanes, rows, chunk_rows, true),
                         salt);
}

// The consumer: its state as sketch_tile::peel_setup lays it out (y then
// holds the dequantized floats on the int leg). TS as in the producer.
// block_rounds, where not NULL, takes each block's rounds run.
template <bool kResident, typename TS>
__global__ void __launch_bounds__(kPeelThreads, kPeelBlocksPerSM)
wire_peel_kernel(const TS* __restrict__ sketch,
                 const uint32_t* __restrict__ words,
                 const int* __restrict__ ids, const int* __restrict__ row_ptr,
                 const int* __restrict__ ent, const int* __restrict__ hrow,
                 const float* __restrict__ sign,
                 const int* __restrict__ exps, int mbits,
                 float* __restrict__ values, int8_t* __restrict__ residual,
                 int* __restrict__ block_rounds, float* state, int group,
                 int lanes, int rows, int rounds, uint32_t salt) {
  extern __shared__ float smem[];
  const int n = group * lanes, nw = n / 32, ns = rows * lanes;
  const long long blk = blockIdx.x;
  const PeelPlanes p =
      peel_setup<kResident>(smem, state, blk, (uint32_t)ids[blk], row_ptr,
                            ent, hrow, sign, group, lanes, rows, salt);
  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(exps[blk] - mbits);
  load_sketch(p.y, sketch + blk * ns, ns, s);
  const uint32_t* wg = words + blk * nw;
  if ((nw & 3) == 0 && ((reinterpret_cast<uintptr_t>(wg) |
                         reinterpret_cast<uintptr_t>(p.org)) & 15) == 0) {
    for (int k = threadIdx.x; k < nw / 4; k += blockDim.x) {
      const uint4 v = reinterpret_cast<const uint4*>(wg)[k];
      reinterpret_cast<uint4*>(p.org)[k] = v;
      reinterpret_cast<uint4*>(p.bw)[k] = v;
    }
  } else {
    for (int w = threadIdx.x; w < nw; w += blockDim.x) p.org[w] = p.bw[w] = wg[w];
  }
  __syncthreads();

  const int done =
      peel_block(p, values + blk * n, residual + blk * n, n, lanes, rows, rounds);
  if (block_rounds != nullptr && threadIdx.x == 0) block_rounds[blk] = done;
}

// The producer's instance for this geometry: kRegRows 8 or 0.
template <typename TS>
const void* encode_kernel_of(int lanes, int rows) {
  return encode_reg_rows(lanes, rows)
             ? (const void*)wire_encode_kernel<8, TS>
             : (const void*)wire_encode_kernel<0, TS>;
}

template <typename TS>
int launch_encode(const float* x, const int* ids, const int* cptr,
                  const int* ent, const float* ent_sign, TS* sketch,
                  uint32_t* words, float* maxabs, const int* exps,
                  long long* phase, float* plane, int mbits, int nb,
                  int group, int lanes, int rows, int chunk_rows,
                  uint32_t salt, cudaStream_t stream) {
  const size_t smem =
      encode_smem(group, lanes, rows, chunk_rows, plane == nullptr);
  int err = set_smem(encode_kernel_of<TS>(lanes, rows), smem);
  if (err) return err;
  if (nb > 0) {
    const int threads = encode_threads(lanes);
#define SKETCH_WIRE_ENCODE(R)                                              \
  wire_encode_kernel<R, TS><<<nb, threads, smem, stream>>>(                \
      x, ids, cptr, ent, ent_sign, sketch, words, maxabs, exps, phase,     \
      plane, mbits, group, lanes, rows, chunk_rows, salt)
    if (encode_reg_rows(lanes, rows)) SKETCH_WIRE_ENCODE(8);
    else SKETCH_WIRE_ENCODE(0);
#undef SKETCH_WIRE_ENCODE
  }
  return (int)cudaGetLastError();
}

template <bool kResident, typename TS>
int launch_peel(const TS* sketch, const uint32_t* words, const int* ids,
                const int* row_ptr, const int* ent, const int* hrow,
                const float* sign, const int* exps, int mbits, float* values,
                int8_t* residual, int* block_rounds, float* state, int nb,
                int group, int lanes, int rows, int rounds, uint32_t salt,
                size_t smem, cudaStream_t stream) {
  int err = set_smem((const void*)wire_peel_kernel<kResident, TS>, smem);
  if (err) return err;
  if (nb > 0)
    wire_peel_kernel<kResident, TS><<<nb, kPeelThreads, smem, stream>>>(
        sketch, words, ids, row_ptr, ent, hrow, sign, exps, mbits, values,
        residual, block_rounds, state, group, lanes, rows, rounds, salt);
  return (int)cudaGetLastError();
}

// Each kernel of this file with its block size at this geometry: 0/1 the
// producer's f32 and quantize legs, 2/3 the consumer's f32 and dequant
// legs.
const void* kernel_of(int kind, int lanes, int rows, int resident,
                      int* threads) {
  *threads = kind < 2 ? encode_threads(lanes) : kPeelThreads;
  switch (kind) {
    case 0: return encode_kernel_of<float>(lanes, rows);
    case 1: return encode_kernel_of<int>(lanes, rows);
    case 2: return resident ? (const void*)wire_peel_kernel<true, float>
                            : (const void*)wire_peel_kernel<false, float>;
    case 3: return resident ? (const void*)wire_peel_kernel<true, int>
                            : (const void*)wire_peel_kernel<false, int>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may opt in to on `device`, or a
// negative cudaError_t.
int sketch_wire_max_smem(int device) { return max_smem_optin(device); }

// Dynamic shared memory of each kernel; `resident` keeps the producer's
// accumulator plane (its plane variant, many rows or lanes) or the
// consumer's y, degrees and contributions there too.
size_t sketch_wire_encode_smem(int group, int lanes, int rows, int chunk_rows,
                               int resident) {
  return encode_smem(group, lanes, rows, chunk_rows, resident);
}

size_t sketch_wire_peel_smem(int group, int lanes, int rows, int resident) {
  return peel_smem(group, lanes, rows, resident);
}

// Threads of a block of kernel `kind` (see kernel_of) at `lanes`.
int sketch_wire_threads(int kind, int lanes) {
  return kind < 2 ? encode_threads(lanes) : kPeelThreads;
}

// Blocks of kernel `kind` (see kernel_of) that one SM of the current
// device holds at once at this geometry, or a negative cudaError_t.
int sketch_wire_occupancy(int kind, int group, int lanes, int rows,
                          int chunk_rows, int resident) {
  int threads = 0;
  const void* fn = kernel_of(kind, lanes, rows, resident, &threads);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  const size_t smem =
      kind < 2 ? encode_smem(group, lanes, rows, chunk_rows, resident)
               : peel_smem(group, lanes, rows, resident);
  return occupancy(fn, threads, smem);
}

// exps == NULL: the f32 wire, `sketch` is float. Otherwise the quantize
// leg: (nb,) int32 exponents, mantissa bits `mbits`, `sketch` is int32.
// cptr/ent/ent_sign list the pairs per (chunk of chunk_rows batch rows,
// sketch row); phase is NULL or (nb, 3) int64; plane is NULL or, where the
// plane variant's plane does not fit shared memory, (nb, rows, lanes) f32
// scratch.
int sketch_wire_encode(const float* x, const int* ids, const int* cptr,
                       const int* ent, const float* ent_sign, void* sketch,
                       int* words, float* maxabs, const int* exps,
                       long long* phase, float* plane, int nb, int group,
                       int lanes, int rows, int chunk_rows, int mbits,
                       unsigned salt, void* stream) {
  uint32_t* w = reinterpret_cast<uint32_t*>(words);
  cudaStream_t st = (cudaStream_t)stream;
  if (exps == nullptr)
    return launch_encode(x, ids, cptr, ent, ent_sign,
                         static_cast<float*>(sketch), w, maxabs, exps, phase,
                         plane, mbits, nb, group, lanes, rows, chunk_rows,
                         salt, st);
  return launch_encode(x, ids, cptr, ent, ent_sign, static_cast<int*>(sketch),
                       w, maxabs, exps, phase, plane, mbits, nb, group, lanes,
                       rows, chunk_rows, salt, st);
}

// state (nb, 4, rows, lanes) f32 is scratch for resident == 0 and unused
// otherwise; block_rounds is NULL or (nb,) int32, each block's rounds run.
// exps == NULL: `sketch` is the f32 aggregate; otherwise the int32 fxp32
// aggregate, dequantized with (nb,) int32 exponents and mantissa bits
// `mbits`.
int sketch_wire_peel(const void* sketch, const int* words, const int* ids,
                     const int* row_ptr, const int* ent, const int* hrow,
                     const float* sign, const int* exps, float* values,
                     signed char* residual, int* block_rounds, float* state,
                     int nb, int group, int lanes, int rows, int rounds,
                     int mbits, int resident, unsigned salt, void* stream) {
  const size_t smem = sketch_wire_peel_smem(group, lanes, rows, resident);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  int8_t* res = reinterpret_cast<int8_t*>(residual);
  cudaStream_t st = (cudaStream_t)stream;
  if (exps == nullptr) {
    const float* sk = static_cast<const float*>(sketch);
    return resident
               ? launch_peel<true>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                   mbits, values, res, block_rounds, state, nb,
                                   group, lanes, rows, rounds, salt, smem, st)
               : launch_peel<false>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                    mbits, values, res, block_rounds, state, nb,
                                    group, lanes, rows, rounds, salt, smem, st);
  }
  const int* sk = static_cast<const int*>(sketch);
  return resident
             ? launch_peel<true>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                 mbits, values, res, block_rounds, state, nb,
                                 group, lanes, rows, rounds, salt, smem, st)
             : launch_peel<false>(sk, w, ids, row_ptr, ent, hrow, sign, exps,
                                  mbits, values, res, block_rounds, state, nb,
                                  group, lanes, rows, rounds, salt, smem, st);
}

}  // extern "C"
