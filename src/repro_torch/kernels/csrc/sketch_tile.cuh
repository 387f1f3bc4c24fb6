// Device code shared by every sketch kernel: the hash mixer and block
// rotations, the owner-sum encode of one block and the peel of one block.
//
// The fused wire kernels (sketch_wire.cu) and the standalone encode and
// peel kernels (sketch_codec.cu) run exactly this code, as the reference's
// fused Pallas kernels share encode_tile and peel_tile with the plain ones
// (src/repro/kernels/sketch_encode.py, sketch_peel.py): the standalone
// sketch equals the fused producer's, and the standalone peel the fused
// consumer's on the same bits, bit for bit on any input.
//
// Layout of a block: element e = i * lanes + l of batch i, lane l;
// n = group * lanes elements; bit word w holds elements 32w .. 32w + 31,
// bit k for element 32w + k, and the bits past n in the last word are 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sketch_tile {

constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// rot[3i + j] = rot_j(i, blk), as src/repro/core/hashing.py:block_rotations.
__device__ __forceinline__ void block_rotations(int* rot, uint32_t blk,
                                                int group, int lanes,
                                                uint32_t salt) {
  for (int t = threadIdx.x; t < group * 3; t += blockDim.x) {
    uint32_t key = blk * 0x01000193u + (uint32_t)t + salt;
    rot[t] = (int)(mix32(key) % (uint32_t)lanes);
  }
}

// Exact float 2^k for k in [-126, 127] (net/fixedpoint.py:pow2).
__device__ __forceinline__ float pow2f(int k) {
  return __int_as_float((k + 127) << 23);
}

// A sketch cell as the wire carries it: f32, or the fxp32 int32 at the
// block's scale s (2^(M-e) to store, 2^(e-M) to load).
__device__ __forceinline__ void store_cell(float* p, float acc, float) {
  *p = acc;
}
__device__ __forceinline__ void store_cell(int* p, float acc, float s) {
  *p = __float2int_rn(acc * s);
}
__device__ __forceinline__ float load_cell(const float* p, float) {
  return *p;
}
__device__ __forceinline__ float load_cell(const int* p, float s) {
  return __int2float_rn(*p) * s;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Count-Sketch encode of one block from its values xs (shared or device
// memory) into sb (rows, lanes). Every sketch cell (r, m) is owned by one
// thread, which sums its contributions in the reference's (i, j) order
// from 0.0 using the per-row list of the (i, j) pairs that hash to row r
// (row_ptr/ent, with their signs): no atomics. Returns the thread's
// max |cell|.
template <typename TS>
__device__ __forceinline__ float encode_cells(
    const float* xs, const int* rot, const int* __restrict__ row_ptr,
    const int* __restrict__ ent, const float* __restrict__ ent_sign, TS* sb,
    float s, int lanes, int rows) {
  float mx = 0.0f;
  for (int m = threadIdx.x; m < lanes; m += blockDim.x) {
    for (int r = 0; r < rows; ++r) {
      float acc = 0.0f;
      for (int q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
        const int t = ent[q];
        int src = m - rot[t];
        if (src < 0) src += lanes;
        acc += ent_sign[q] * xs[(t / 3) * lanes + src];
      }
      store_cell(sb + r * lanes + m, acc, s);
      mx = fmaxf(mx, fabsf(acc));
    }
  }
  return mx;
}

// Bytes of dynamic shared memory an encode needs: the x block when
// `resident`, then the rotations.
inline size_t encode_smem(int group, int lanes, int resident) {
  return sizeof(float) * (resident ? (size_t)group * lanes : 0) +
         sizeof(int) * 3 * (size_t)group;
}

// Where a peel keeps its state: y, val, d in shared memory (kResident) or
// in the block's device-memory planes (y_dev, d_dev; val is the output),
// then the current bits, the bits peeled this round and the rotations in
// shared memory. nw = ceil(n / 32) words of bits.
struct PeelPlanes {
  float* y;
  float* val;
  int* d;
  uint32_t* bw;
  uint32_t* pk;
  int* rot;
};

template <bool kResident>
__device__ __forceinline__ PeelPlanes peel_planes(float* smem, float* y_dev,
                                                  int* d_dev, float* vout,
                                                  long long blk, int n, int ns,
                                                  int nw) {
  PeelPlanes p;
  if constexpr (kResident) {
    p.y = smem;
    p.val = p.y + ns;
    p.d = reinterpret_cast<int*>(p.val + n);
    p.bw = reinterpret_cast<uint32_t*>(p.d + ns);
  } else {
    // Barriers order device-memory accesses within a block as they do
    // shared ones, so the rounds below hold as written.
    p.y = y_dev + blk * ns;
    p.d = d_dev + blk * ns;
    p.val = vout;
    p.bw = reinterpret_cast<uint32_t*>(smem);
  }
  p.pk = p.bw + nw;
  p.rot = reinterpret_cast<int*>(p.pk + nw);
  return p;
}

// Bytes of dynamic shared memory a peel needs (the layout above).
inline size_t peel_smem(int group, int lanes, int rows, int resident) {
  const size_t n = (size_t)group * lanes, ns = (size_t)rows * lanes;
  return (resident ? sizeof(float) * (ns + n) + sizeof(int) * ns : 0) +
         sizeof(uint32_t) * 2 * ((n + 31) / 32) + sizeof(int) * 3 * (size_t)group;
}

// The peel of one block, after y and the bits bw are loaded and the
// rotations computed (a barrier since): initial degrees, exactly `rounds`
// synchronous peel rounds, and the median-of-3 estimate for bits still
// set. `orig(e)` is element e's input bit: an element whose input bit is
// clear gets 0. Writes vout (n) and rout (n).
template <bool kResident, typename OrigBit>
__device__ __forceinline__ void peel_block(
    const PeelPlanes& p, const int* __restrict__ row_ptr,
    const int* __restrict__ ent, const float* __restrict__ ent_sign,
    const int* __restrict__ hrow, const float* __restrict__ sign,
    float* vout, int8_t* rout, OrigBit orig, int n, int lanes, int rows,
    int rounds) {
  float* y = p.y;
  float* val = p.val;
  int* d = p.d;
  uint32_t* bw = p.bw;
  uint32_t* pk = p.pk;
  const int* rot = p.rot;
  // Every warp covers whole words: the element loop with a ballot runs to
  // n rounded up to 32, and bits past n are clear, so those are no-ops.
  const int n_up = (n + 31) & ~31;

  // Initial degrees: cell (r, m) counts the indexed coordinates hashing to it.
  for (int m = threadIdx.x; m < lanes; m += blockDim.x) {
    for (int r = 0; r < rows; ++r) {
      int cnt = 0;
      for (int q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
        const int t = ent[q];
        int src = m - rot[t];
        if (src < 0) src += lanes;
        const int e = (t / 3) * lanes + src;
        cnt += (bw[e >> 5] >> (e & 31)) & 1u;
      }
      d[r * lanes + m] = cnt;
    }
  }
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    // Gather on the round-start y and d: a set bit with a singleton cell
    // is peeled, its value taken from the first such hash j.
    for (int e = threadIdx.x; e < n_up; e += blockDim.x) {
      bool peel = false;
      float v = 0.0f;
      if ((bw[e >> 5] >> (e & 31)) & 1u) {
        const int i = e / lanes, l = e - i * lanes;
        for (int j = 0; j < 3; ++j) {
          const int t = 3 * i + j;
          int col = l + rot[t];
          if (col >= lanes) col -= lanes;
          const int c = hrow[t] * lanes + col;
          if (d[c] == 1) {
            v = sign[t] * y[c];
            peel = true;
            break;
          }
        }
      }
      const unsigned pw = __ballot_sync(0xffffffffu, peel);
      if (peel) {
        if constexpr (kResident) val[e] = v;
        vout[e] = 0.0f + v;  // each element is peeled at most once
      }
      if ((threadIdx.x & 31) == 0) {
        pk[e >> 5] = pw;
        bw[e >> 5] &= ~pw;
      }
    }
    __syncthreads();
    // Scatter: subtract this round's peeled values and degrees from every
    // cell they hash to, each cell summed by its owner in (i, j) order.
    for (int m = threadIdx.x; m < lanes; m += blockDim.x) {
      for (int r = 0; r < rows; ++r) {
        float dy = 0.0f;
        int dd = 0;
        for (int q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
          const int t = ent[q];
          int src = m - rot[t];
          if (src < 0) src += lanes;
          const int e = (t / 3) * lanes + src;
          if ((pk[e >> 5] >> (e & 31)) & 1u) {
            dy += ent_sign[q] * val[e];
            ++dd;
          }
        }
        y[r * lanes + m] -= dy;
        d[r * lanes + m] -= dd;
      }
    }
    __syncthreads();
  }

  // Bits still set take the median-of-3 estimate, sum - max - min.
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int8_t res = 0;
    if ((bw[e >> 5] >> (e & 31)) & 1u) {
      const int i = e / lanes, l = e - i * lanes;
      float v[3];
      for (int j = 0; j < 3; ++j) {
        const int t = 3 * i + j;
        int col = l + rot[t];
        if (col >= lanes) col -= lanes;
        v[j] = sign[t] * y[hrow[t] * lanes + col];
      }
      const float med = v[0] + v[1] + v[2] - fmaxf(fmaxf(v[0], v[1]), v[2]) -
                        fminf(fminf(v[0], v[1]), v[2]);
      vout[e] = 0.0f + med;
      res = 1;
    } else if (!orig(e)) {
      vout[e] = 0.0f;
    }
    rout[e] = res;
  }
}

// The input bit of element e: from packed words, or from one byte each.
struct WordBits {
  const uint32_t* w;
  __device__ __forceinline__ bool operator()(int e) const {
    return (w[e >> 5] >> (e & 31)) & 1u;
  }
};
struct ByteBits {
  const uint8_t* b;
  __device__ __forceinline__ bool operator()(int e) const { return b[e] != 0; }
};

// The most dynamic shared memory a block may opt in to on `device`, or a
// negative cudaError_t.
inline int max_smem_optin(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}

inline int set_smem(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // clear it; report it below
  return (int)err;
}

}  // namespace sketch_tile
