// The keys of a table equality, shared by K13d's primary-key dedup
// (k13d_table_insert.cu) and K13e's equality route (k13e_last_match.cu):
// up to MAX_KEYS columns, each compared as the compiled `==` compares it
// (JAX's and torch's `==` in the columns' one type), ANDed.
//
// Integers, bools and string codes compare bitwise; floats as floats: NaN
// equals nothing and -0.0 equals +0.0. A key with a NaN column so equals no
// key; on the other keys `==` is an equivalence whose classes are the
// canonical values (-0.0 read as +0.0, every other value by its bits), so
// one hash of the canonical columns (splitmix64 mixing, column order kept)
// puts equal keys in one class. Each source is its own library, so each
// carries its own copy of these definitions.
#pragma once

#include "common.cuh"

namespace {

constexpr int MAX_KEYS = 4;

enum KeyType { K_I8 = 0, K_I32 = 1, K_I64 = 2, K_F32 = 3, K_F64 = 4 };

// Key columns of one side ([n] each), all of one length.
struct KeyCols {
  const void* col[MAX_KEYS];
  int type[MAX_KEYS];
  int n;
};

// Column value i as its canonical 64 bits; false for NaN.
__device__ __forceinline__ bool canonical(const void* p, int type, int i,
                                          unsigned long long* v) {
  switch (type) {
    case K_I8:
      *v = static_cast<long long>(static_cast<const signed char*>(p)[i]);
      return true;
    case K_I32:
      *v = static_cast<long long>(static_cast<const int*>(p)[i]);
      return true;
    case K_I64:
      *v = static_cast<const unsigned long long*>(p)[i];
      return true;
    case K_F32: {
      const float f = static_cast<const float*>(p)[i];
      *v = f == 0.0f ? 0ull : __float_as_uint(f);
      return f == f;
    }
    default: {
      const double d = static_cast<const double*>(p)[i];
      *v = d == 0.0 ? 0ull
                    : static_cast<unsigned long long>(__double_as_longlong(d));
      return d == d;
    }
  }
}

// Element i's key over every column; false if a column is NaN.
__device__ __forceinline__ bool read_key(const KeyCols& keys, int i,
                                         unsigned long long* v) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k)
    if (k < keys.n) ok &= canonical(keys.col[k], keys.type[k], i, &v[k]);
  return ok;
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// The hash of a canonical key of n columns.
__device__ __forceinline__ unsigned long long key_hash(
    const unsigned long long* v, int n) {
  unsigned long long h = 0;
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k)
    if (k < n) h = mix64(h ^ v[k]);
  return h;
}

__device__ __forceinline__ bool key_equal(const unsigned long long* a,
                                          const unsigned long long* b,
                                          int n) {
  bool eq = true;
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k)
    if (k < n) eq &= a[k] == b[k];
  return eq;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

}  // namespace
