// Chunk codecs of zarr v2 stores, written for this repository.
//
// Decoders: Blosc 1 frames (blosclz, lz4/lz4hc, snappy, zlib and zstd
// streams; byte and bit shuffle; split and unsplit blocks; memcpyed frames),
// zstd frames (RFC 8878: raw / RLE / compressed blocks, Huffman and FSE,
// repeat offsets, XXH64 checksums, skippable and concatenated frames), LZ4
// blocks, BloscLZ streams, Snappy blocks and zlib streams (RFC 1950/1951).
// Encoders: Blosc 1 frames with zstd, lz4, snappy or zlib streams (blosclz
// and a clevel of 0 write a memcpyed frame), zstd frames (hash-chain LZ77
// whose effort follows the level, Huffman literals, sequences on the
// predefined FSE tables), LZ4 and Snappy blocks and zlib streams
// (fixed-Huffman deflate).
//
// No codec library is linked or included. Every entry point is reentrant:
// the only state is on the stack or in buffers allocated by the call. A
// malformed input returns a negative code (see the E_* values) and never
// reads or writes outside the buffers it was given.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 zcodec.cpp -o libzcodec.so

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <queue>
#include <utility>
#include <vector>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "zcodec.cpp assumes a little-endian host"
#endif

namespace {

enum : int64_t {
  E_CORRUPT = -1,      // malformed or truncated input
  E_OVERRUN = -2,      // the output would not fit the buffer given
  E_MAGIC = -3,        // not a frame of the codec asked for
  E_CHECKSUM = -4,     // a stored checksum does not match the content
  E_DICT = -6,         // a zstd frame that needs a dictionary
  E_UNSUPPORTED = -7,  // a format version or codec this file lacks
  E_ARG = -8,          // bad arguments
  E_NOMEM = -9,
};

struct Fail {
  int64_t code;
};
[[noreturn]] void fail(int64_t code) { throw Fail{code}; }
inline void need(bool ok, int64_t code = E_CORRUPT) {
  if (!ok) fail(code);
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline void wr32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

template <class F>
int64_t guarded(F&& f) {
  try {
    return f();
  } catch (const Fail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return E_NOMEM;
  } catch (...) {
    return E_CORRUPT;
  }
}

// Copies a match of `len` bytes from `dist` bytes back; the ranges may
// overlap (dist < len repeats the last `dist` bytes).
inline void copy_match(uint8_t* op, size_t dist, size_t len) {
  const uint8_t* m = op - dist;
  if (dist >= len) {
    memcpy(op, m, len);
  } else if (dist >= 8) {
    while (len) {
      size_t k = std::min(dist, len);
      memcpy(op, m, k);
      op += k;
      m += k;
      len -= k;
    }
  } else {
    for (size_t i = 0; i < len; i++) op[i] = m[i];
  }
}

// ------------------------------------------------------------- shuffles

void shuffle_bytes(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  size_t ne = n / ts;
  for (size_t i = 0; i < ne; i++)
    for (size_t j = 0; j < ts; j++) dst[j * ne + i] = src[i * ts + j];
  memcpy(dst + ne * ts, src + ne * ts, n - ne * ts);
}

void unshuffle_bytes(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  size_t ne = n / ts;
  if (ts == 2) {
    const uint8_t *a = src, *b = src + ne;
    for (size_t i = 0; i < ne; i++) {
      dst[2 * i] = a[i];
      dst[2 * i + 1] = b[i];
    }
  } else if (ts == 4) {
    const uint8_t *a = src, *b = src + ne, *c = src + 2 * ne, *d = src + 3 * ne;
    for (size_t i = 0; i < ne; i++) {
      dst[4 * i] = a[i];
      dst[4 * i + 1] = b[i];
      dst[4 * i + 2] = c[i];
      dst[4 * i + 3] = d[i];
    }
  } else {
    for (size_t i = 0; i < ne; i++)
      for (size_t j = 0; j < ts; j++) dst[i * ts + j] = src[j * ne + i];
  }
  memcpy(dst + ne * ts, src + ne * ts, n - ne * ts);
}

// Transposes the 8x8 bit matrix whose row r is byte r of x (bit c = column
// c): bit 8r+c moves to 8c+r.
inline uint64_t transpose8(uint64_t x) {
  x = (x & 0xAA55AA55AA55AA55ULL) | ((x & 0x00AA00AA00AA00AAULL) << 7) |
      ((x >> 7) & 0x00AA00AA00AA00AAULL);
  x = (x & 0xCCCC3333CCCC3333ULL) | ((x & 0x0000CCCC0000CCCCULL) << 14) |
      ((x >> 14) & 0x0000CCCC0000CCCCULL);
  x = (x & 0xF0F0F0F00F0F0F0FULL) | ((x & 0x00000000F0F0F0F0ULL) << 28) |
      ((x >> 28) & 0x00000000F0F0F0F0ULL);
  return x;
}

// c-blosc 1.x bitshuffle: a block of a multiple of 8 whole elements becomes
// ts * 8 bit planes (byte b, bit k: plane 8b + k, element i at bit i % 8 of
// byte i / 8 of the plane); any other block is copied as it is, whole
// (tensorstore's c-blosc stores a short last block so).
inline size_t bit_elems(size_t n, size_t ts) { return (n / ts) % 8 ? 0 : n / ts; }

inline void transpose_bytes8(uint64_t* y);

void bitshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  size_t ne = bit_elems(n, ts), rows = ne / 8;
  for (size_t b = 0; b < ts; b++) {
    size_t q = 0;
    // 64 elements at a time, stored as 8 bytes of each of the 8 planes
    for (; q + 8 <= rows; q += 8) {
      uint64_t y[8];
      for (int j = 0; j < 8; j++) {
        const uint8_t* s = src + (q + j) * 8 * ts + b;
        uint64_t x;
        if (ts == 1) {
          x = rd64(s);
        } else {
          x = 0;
          for (int t = 0; t < 8; t++) x |= uint64_t(s[t * ts]) << (8 * t);
        }
        y[j] = transpose8(x);
      }
      transpose_bytes8(y);
      uint8_t* d = dst + b * 8 * rows + q;
      for (int k = 0; k < 8; k++) memcpy(d + k * rows, &y[k], 8);
    }
    for (; q < rows; q++) {
      uint64_t x = 0;
      const uint8_t* s = src + q * 8 * ts + b;
      for (int t = 0; t < 8; t++) x |= uint64_t(s[t * ts]) << (8 * t);
      x = transpose8(x);
      uint8_t* d = dst + b * 8 * rows + q;
      for (int k = 0; k < 8; k++) d[k * rows] = uint8_t(x >> (8 * k));
    }
  }
  memcpy(dst + ne * ts, src + ne * ts, n - ne * ts);
}

// Transposes the 8x8 byte matrix of y[0..7] (row r = y[r], column c =
// byte c).
inline void transpose_bytes8(uint64_t* y) {
  for (int i = 0; i < 8; i += 2) {
    uint64_t t = ((y[i] >> 8) ^ y[i + 1]) & 0x00FF00FF00FF00FFULL;
    y[i + 1] ^= t;
    y[i] ^= t << 8;
  }
  for (int i : {0, 1, 4, 5}) {
    uint64_t t = ((y[i] >> 16) ^ y[i + 2]) & 0x0000FFFF0000FFFFULL;
    y[i + 2] ^= t;
    y[i] ^= t << 16;
  }
  for (int i = 0; i < 4; i++) {
    uint64_t t = ((y[i] >> 32) ^ y[i + 4]) & 0x00000000FFFFFFFFULL;
    y[i + 4] ^= t;
    y[i] ^= t << 32;
  }
}

void bitunshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  size_t ne = bit_elems(n, ts), rows = ne / 8;
  for (size_t b = 0; b < ts; b++) {
    const uint8_t* s = src + b * 8 * rows;
    size_t q = 0;
    // 64 elements at a time: 8 bytes of each of the 8 planes
    for (; q + 8 <= rows; q += 8) {
      uint64_t y[8];
      for (int k = 0; k < 8; k++) y[k] = rd64(s + k * rows + q);
      transpose_bytes8(y);
      for (int j = 0; j < 8; j++) {
        uint64_t x = transpose8(y[j]);
        uint8_t* d = dst + (q + j) * 8 * ts + b;
        if (ts == 1) {
          memcpy(d, &x, 8);
        } else {
          for (int t = 0; t < 8; t++) d[t * ts] = uint8_t(x >> (8 * t));
        }
      }
    }
    for (; q < rows; q++) {
      uint64_t x = 0;
      for (int k = 0; k < 8; k++) x |= uint64_t(s[k * rows + q]) << (8 * k);
      x = transpose8(x);
      uint8_t* d = dst + q * 8 * ts + b;
      for (int t = 0; t < 8; t++) d[t * ts] = uint8_t(x >> (8 * t));
    }
  }
  memcpy(dst + ne * ts, src + ne * ts, n - ne * ts);
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------- bit I/O

// Forward, LSB-first reader (FSE table descriptions). Bits past the end
// read as 0; `check_end` fails if more were consumed than exist.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint32_t read(int nb) {
    size_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n) {
      v = rd64(p + byte);
    } else {
      for (size_t i = 0; byte + i < n && i < 8; i++) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    v >>= pos & 7;
    pos += nb;
    return uint32_t(v & ((1ULL << nb) - 1));
  }
  void check_end() const { need(pos <= n * 8); }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward reader (Huffman and FSE bitstreams): the last byte holds a
// marker bit above the last bits written; reading goes towards the start.
// `pos` counts the bits not yet read; bits before the start read as 0.
struct BwdBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;
  void init(const uint8_t* src, size_t len) {
    need(len > 0 && src[len - 1] != 0);
    p = src;
    n = len;
    pos = int64_t(len - 1) * 8 + highbit(src[len - 1]);
  }
  uint32_t at(int64_t off, int nb) const {  // nb <= 32
    if (nb == 0) return 0;
    if (off < 0) {
      if (off + nb <= 0) return 0;
      return at(0, int(nb + off)) << (-off);
    }
    size_t byte = size_t(off) >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n) {
      v = rd64(p + byte);
    } else {
      for (size_t i = 0; byte + i < n; i++) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    return uint32_t((v >> (off & 7)) & ((1ULL << nb) - 1));
  }
  uint32_t read(int nb) {
    pos -= nb;
    return at(pos, nb);
  }
  uint32_t peek(int nb) const { return at(pos - nb, nb); }
  void skip(int nb) { pos -= nb; }
};

// Forward, LSB-first writer; `close` appends the marker bit of a backward
// stream.
struct BitW {
  std::vector<uint8_t>& v;
  uint64_t acc = 0;
  int nb = 0;
  explicit BitW(std::vector<uint8_t>& out) : v(out) {}
  void add(uint64_t val, int n) {  // n <= 32
    acc |= (val & ((1ULL << n) - 1)) << nb;
    nb += n;
    if (nb >= 32) {
      uint8_t b[4];
      wr32(b, uint32_t(acc));
      v.insert(v.end(), b, b + 4);
      acc >>= 32;
      nb -= 32;
    }
  }
  void align() {
    for (; nb > 0; nb -= 8) {
      v.push_back(uint8_t(acc));
      acc >>= 8;
    }
    acc = 0;
    nb = 0;
  }
  void close() {
    add(1, 1);
    align();
  }
};

// ------------------------------------------------------------------ FSE

constexpr int FSE_MAX_AL = 9;

struct FseD {
  int al = -1;
  uint8_t sym[1 << FSE_MAX_AL];
  uint8_t nb[1 << FSE_MAX_AL];
  uint16_t base[1 << FSE_MAX_AL];
};

void fse_spread(const int16_t* norm, int nsym, int al, uint8_t* sym, int* high_out) {
  int size = 1 << al, high = size - 1;
  for (int s = 0; s < nsym; s++)
    if (norm[s] == -1) sym[high--] = uint8_t(s);
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      sym[pos] = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  need(pos == 0);
  *high_out = high;
}

void fse_build_d(FseD& t, const int16_t* norm, int nsym, int al) {
  need(al >= 0 && al <= FSE_MAX_AL && nsym >= 1 && nsym <= 256);
  int size = 1 << al, high;
  uint32_t next[256];
  for (int s = 0; s < nsym; s++) next[s] = norm[s] == -1 ? 1 : uint32_t(std::max<int>(norm[s], 0));
  fse_spread(norm, nsym, al, t.sym, &high);
  for (int i = 0; i < size; i++) {
    uint32_t x = next[t.sym[i]]++;
    need(x > 0);
    int nbits = al - highbit(x);
    need(nbits >= 0);
    t.nb[i] = uint8_t(nbits);
    t.base[i] = uint16_t((x << nbits) - size);
  }
  t.al = al;
}

void fse_rle_d(FseD& t, uint8_t symbol) {
  t.al = 0;
  t.sym[0] = symbol;
  t.nb[0] = 0;
  t.base[0] = 0;
}

// Reads an FSE table description; returns the bytes it took.
size_t fse_read_ncount(const uint8_t* src, size_t len, int16_t* norm, int* nsym,
                       int* al_out, int max_al, int max_sym) {
  need(len > 0);
  FwdBits br{src, len};
  int al = int(br.read(4)) + 5;
  need(al <= max_al);
  int remaining = 1 << al, s = 0;
  while (remaining > 0) {
    need(s <= max_sym);
    int bits = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t val = br.read(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t thr = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < thr) {
      br.pos--;
      val &= lower;
    } else if (val > lower) {
      val -= thr;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[s++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        uint32_t rep = br.read(2);
        for (uint32_t i = 0; i < rep; i++) {
          need(s <= max_sym);
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
    need(br.pos <= len * 8);
  }
  need(remaining == 0);
  br.check_end();
  *nsym = s;
  *al_out = al;
  return br.bytes();
}

struct FseC {
  int al = 0;
  uint16_t st[1 << FSE_MAX_AL];
  int32_t dfs[256];
  uint32_t dnb[256];
};

void fse_build_c(FseC& c, const int16_t* norm, int nsym, int al) {
  int size = 1 << al, high;
  uint8_t sym[1 << FSE_MAX_AL];
  int cumul[257];
  cumul[0] = 0;
  for (int s = 0; s < nsym; s++) cumul[s + 1] = cumul[s] + (norm[s] == -1 ? 1 : norm[s]);
  fse_spread(norm, nsym, al, sym, &high);
  for (int u = 0; u < size; u++) c.st[cumul[sym[u]]++] = uint16_t(size + u);
  int total = 0;
  for (int s = 0; s < nsym; s++) {
    int n = norm[s];
    if (n == 0) {
      c.dnb[s] = uint32_t(((al + 1) << 16) - size);
      c.dfs[s] = 0;
    } else if (n == -1 || n == 1) {
      c.dnb[s] = uint32_t((al << 16) - size);
      c.dfs[s] = total - 1;
      total++;
    } else {
      int max_out = al - highbit(uint32_t(n - 1));
      int min_plus = n << max_out;
      c.dnb[s] = uint32_t((max_out << 16) - min_plus);
      c.dfs[s] = total - n;
      total += n;
    }
  }
  c.al = al;
}

// The first symbol encoded (the last decoded) starts from the state that
// costs the fewest bits.
inline uint32_t fse_init_state(const FseC& c, int s) {
  uint32_t nbo = (c.dnb[s] + (1u << 15)) >> 16;
  uint32_t v = (nbo << 16) - c.dnb[s];
  return c.st[(v >> nbo) + c.dfs[s]];
}
inline void fse_encode(BitW& w, const FseC& c, uint32_t& state, int s) {
  uint32_t nbo = (state + c.dnb[s]) >> 16;
  w.add(state, int(nbo));
  state = c.st[(state >> nbo) + c.dfs[s]];
}

// Scales counts to a sum of 2^al, every present symbol at least 1.
void fse_normalize(const uint32_t* counts, int nsym, int al, int16_t* norm) {
  uint64_t total = 0;
  for (int s = 0; s < nsym; s++) total += counts[s];
  int target = 1 << al, sum = 0;
  for (int s = 0; s < nsym; s++) {
    if (!counts[s]) {
      norm[s] = 0;
      continue;
    }
    int v = int((uint64_t(counts[s]) * target * 2 + total) / (2 * total));
    norm[s] = int16_t(std::max(v, 1));
    sum += norm[s];
  }
  while (sum != target) {
    int best = -1;
    for (int s = 0; s < nsym; s++)
      if (norm[s] > (sum > target ? 1 : 0) && (best < 0 || norm[s] > norm[best])) best = s;
    need(best >= 0, E_ARG);
    norm[best] += sum > target ? -1 : 1;
    sum += sum > target ? -1 : 1;
  }
}

void fse_write_ncount(BitW& w, const int16_t* norm, int nsym, int al) {
  w.add(uint32_t(al - 5), 4);
  int remaining = 1 << al, s = 0;
  while (remaining > 0 && s < nsym) {
    int v = norm[s] + 1;
    int bits = highbit(uint32_t(remaining + 1)) + 1;
    int top = 1 << (bits - 1);
    int thr = (1 << bits) - 1 - (remaining + 1);
    if (v < thr)
      w.add(uint32_t(v), bits - 1);
    else if (v < top)
      w.add(uint32_t(v), bits);
    else
      w.add(uint32_t(v + thr), bits);
    remaining -= norm[s] < 0 ? -norm[s] : norm[s];
    s++;
    if (norm[s - 1] == 0) {
      int z = 0;
      while (s + z < nsym && norm[s + z] == 0) z++;
      s += z;
      while (z >= 3) {
        w.add(3, 2);
        z -= 3;
      }
      w.add(uint32_t(z), 2);
    }
  }
  w.align();
}

// ------------------------------------------------------------- Huffman

constexpr int HUF_MAX_BITS = 12;

struct HufD {
  int maxbits = 0;
  uint16_t dt[1 << HUF_MAX_BITS];  // symbol | bits << 8
};

// Reads a Huffman tree description; returns the bytes it took.
size_t huf_read_table(const uint8_t* src, size_t len, HufD& t) {
  need(len >= 1);
  uint8_t w[256];
  int nw = 0;
  size_t used;
  int h = src[0];
  if (h >= 128) {
    nw = h - 127;
    size_t nbytes = size_t(nw + 1) / 2;
    need(1 + nbytes <= len);
    for (int i = 0; i < nw; i++) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    used = 1 + nbytes;
  } else {
    size_t csize = size_t(h);
    need(csize >= 2 && 1 + csize <= len);
    int16_t norm[256];
    int nsym, al;
    size_t hdr = fse_read_ncount(src + 1, csize, norm, &nsym, &al, 6, HUF_MAX_BITS);
    need(hdr < csize);
    FseD ft;
    fse_build_d(ft, norm, nsym, al);
    BwdBits br;
    br.init(src + 1 + hdr, csize - hdr);
    uint32_t s1 = br.read(al), s2 = br.read(al);
    auto put = [&](uint32_t state) {
      need(nw < 255);
      w[nw++] = ft.sym[state];
    };
    for (;;) {
      put(s1);
      s1 = ft.base[s1] + br.read(ft.nb[s1]);
      if (br.pos < 0) {
        put(s2);
        break;
      }
      put(s2);
      s2 = ft.base[s2] + br.read(ft.nb[s2]);
      if (br.pos < 0) {
        put(s1);
        break;
      }
    }
    used = 1 + csize;
  }
  uint32_t wsum = 0;
  for (int i = 0; i < nw; i++) {
    need(w[i] <= HUF_MAX_BITS);
    if (w[i]) wsum += 1u << (w[i] - 1);
  }
  need(wsum > 0 && nw <= 255);
  int maxbits = highbit(wsum) + 1;
  need(maxbits <= HUF_MAX_BITS);
  uint32_t left = (1u << maxbits) - wsum;
  need((left & (left - 1)) == 0);
  w[nw] = uint8_t(highbit(left) + 1);
  int nsym = nw + 1;
  uint8_t bits[256];
  int rank_count[HUF_MAX_BITS + 2] = {0};
  for (int s = 0; s < nsym; s++) {
    bits[s] = w[s] ? uint8_t(maxbits + 1 - w[s]) : 0;
    rank_count[bits[s]]++;
  }
  uint32_t rank_idx[HUF_MAX_BITS + 2];
  rank_idx[maxbits] = 0;
  for (int i = maxbits; i >= 1; i--)
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (maxbits - i));
  need(rank_idx[0] == (1u << maxbits));
  for (int s = 0; s < nsym; s++) {
    if (!bits[s]) continue;
    uint32_t span = 1u << (maxbits - bits[s]);
    uint16_t e = uint16_t(s | (bits[s] << 8));
    for (uint32_t k = 0; k < span; k++) t.dt[rank_idx[bits[s]] + k] = e;
    rank_idx[bits[s]] += span;
  }
  t.maxbits = maxbits;
  return used;
}

// One backward Huffman stream; `window` decodes 4 symbols from one 57-bit
// window of it (4 x 12 bits <= 57) while the window lies inside the stream.
struct HufStream {
  BwdBits br;
  uint8_t* out;
  size_t n, i = 0;
  bool can_window() const { return n - i >= 4 && br.pos >= 57; }
};

inline void huf_window(const HufD& t, HufStream& s) {
  const int mb = t.maxbits;
  int64_t lo = s.br.pos - 57;
  uint64_t w = rd64(s.br.p + (lo >> 3)) >> (lo & 7);
  int c = 57;
  for (int k = 0; k < 4; k++) {
    uint32_t v = uint32_t((w >> (c - mb)) & ((1u << mb) - 1));
    uint16_t e = t.dt[v];
    s.out[s.i + k] = uint8_t(e);
    c -= e >> 8;
  }
  s.br.pos -= 57 - c;
  s.i += 4;
}

void huf_finish(const HufD& t, HufStream& s) {
  while (s.can_window()) huf_window(t, s);
  for (; s.i < s.n; s.i++) {
    uint16_t e = t.dt[s.br.peek(t.maxbits)];
    s.out[s.i] = uint8_t(e);
    s.br.skip(e >> 8);
  }
  need(s.br.pos == 0);
}

// Decodes `nstreams` (1 or 4) streams; four are interleaved for the
// independent chains' sake.
void huf_decode_streams(const HufD& t, const uint8_t* const* src, const size_t* len,
                        uint8_t* const* out, const size_t* nout, int nstreams) {
  HufStream st[4];
  for (int k = 0; k < nstreams; k++) {
    st[k].br.init(src[k], len[k]);
    st[k].out = out[k];
    st[k].n = nout[k];
  }
  if (nstreams == 4) {
    while (st[0].can_window() && st[1].can_window() && st[2].can_window() &&
           st[3].can_window()) {
      huf_window(t, st[0]);
      huf_window(t, st[1]);
      huf_window(t, st[2]);
      huf_window(t, st[3]);
    }
  }
  for (int k = 0; k < nstreams; k++) huf_finish(t, st[k]);
}

struct HufC {
  uint16_t code[256];
  uint8_t len[256];
  int maxbits = 0;
  int maxsym = 0;
};

// Length-limited canonical Huffman code of `counts` (at least two symbols
// present), in the order the zstd decoder assigns codes.
void huf_build(const uint32_t* counts, HufC& h, int limit) {
  std::vector<std::pair<uint64_t, int>> nodes;
  std::vector<int> parent;
  using Item = std::pair<uint64_t, int>;
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
  int maxsym = 0;
  for (int s = 0; s < 256; s++) {
    h.len[s] = 0;
    if (counts[s]) {
      pq.push({counts[s], int(parent.size())});
      nodes.push_back({counts[s], s});
      parent.push_back(-1);
      maxsym = s;
    }
  }
  size_t nleaves = parent.size();
  while (pq.size() > 1) {
    Item a = pq.top();
    pq.pop();
    Item b = pq.top();
    pq.pop();
    int id = int(parent.size());
    parent.push_back(-1);
    parent[a.second] = id;
    parent[b.second] = id;
    pq.push({a.first + b.first, id});
  }
  const uint32_t one = 1u << limit;
  uint32_t kraft = 0;
  for (size_t i = 0; i < nleaves; i++) {
    int d = 0;
    for (int j = int(i); parent[j] >= 0; j = parent[j]) d++;
    int s = nodes[i].second;
    h.len[s] = uint8_t(std::min(d, limit));
    kraft += one >> h.len[s];
  }
  while (kraft > one) {  // lengthen the longest codes that can grow
    int best = -1;
    for (int s = 0; s <= maxsym; s++)
      if (h.len[s] && h.len[s] < limit &&
          (best < 0 || h.len[s] > h.len[best] ||
           (h.len[s] == h.len[best] && counts[s] < counts[best])))
        best = s;
    h.len[best]++;
    kraft -= one >> h.len[best];
  }
  while (kraft < one) {  // complete the code: shorten where it fits
    int best = -1;
    for (int s = 0; s <= maxsym; s++)
      if (h.len[s] > 1 && (one >> h.len[s]) <= one - kraft &&
          (best < 0 || h.len[s] > h.len[best] ||
           (h.len[s] == h.len[best] && counts[s] > counts[best])))
        best = s;
    kraft += one >> h.len[best];
    h.len[best]--;
  }
  int maxbits = 0, cnt[HUF_MAX_BITS + 2] = {0};
  for (int s = 0; s <= maxsym; s++) {
    maxbits = std::max<int>(maxbits, h.len[s]);
    cnt[h.len[s]]++;
  }
  uint32_t start[HUF_MAX_BITS + 2];
  start[maxbits] = 0;
  for (int l = maxbits; l >= 1; l--) start[l - 1] = start[l] + (cnt[l] << (maxbits - l));
  for (int s = 0; s <= maxsym; s++) {
    int l = h.len[s];
    if (!l) continue;
    h.code[s] = uint16_t(start[l] >> (maxbits - l));
    start[l] += 1u << (maxbits - l);
  }
  h.maxbits = maxbits;
  h.maxsym = maxsym;
}

// The tree description of `h`: 4-bit weights, or FSE-coded weights where
// that is shorter. Returns false where neither fits.
bool huf_write_table(const HufC& h, std::vector<uint8_t>& out) {
  int nw = h.maxsym;  // the last symbol's weight is implied
  uint8_t w[256];
  for (int s = 0; s < nw; s++) w[s] = h.len[s] ? uint8_t(h.maxbits + 1 - h.len[s]) : 0;
  std::vector<uint8_t> fse;
  if (nw >= 2) {
    uint32_t counts[HUF_MAX_BITS + 1] = {0};
    int nsym = 0;
    for (int s = 0; s < nw; s++) {
      counts[w[s]]++;
      nsym = std::max(nsym, w[s] + 1);
    }
    int16_t norm[HUF_MAX_BITS + 1];
    fse_normalize(counts, nsym, 6, norm);
    FseC c;
    fse_build_c(c, norm, nsym, 6);
    BitW bw(fse);
    fse_write_ncount(bw, norm, nsym, 6);
    int i = nw;
    uint32_t s1, s2;
    if (nw & 1) {
      s1 = fse_init_state(c, w[--i]);
      s2 = fse_init_state(c, w[--i]);
      fse_encode(bw, c, s1, w[--i]);
    } else {
      s2 = fse_init_state(c, w[--i]);
      s1 = fse_init_state(c, w[--i]);
    }
    while (i > 0) {
      fse_encode(bw, c, s2, w[--i]);
      fse_encode(bw, c, s1, w[--i]);
    }
    bw.add(s2, 6);
    bw.add(s1, 6);
    bw.close();
  }
  size_t direct = nw <= 128 ? 1 + size_t(nw + 1) / 2 : SIZE_MAX;
  bool use_fse = !fse.empty() && fse.size() < 128 && 1 + fse.size() < direct;
  if (use_fse) {
    out.push_back(uint8_t(fse.size()));
    out.insert(out.end(), fse.begin(), fse.end());
    return true;
  }
  if (direct == SIZE_MAX) return false;
  out.push_back(uint8_t(127 + nw));
  for (int s = 0; s < nw; s += 2)
    out.push_back(uint8_t((w[s] << 4) | (s + 1 < nw ? w[s + 1] : 0)));
  return true;
}

// The symbols last to first, so the decoder reads them first to last; 4
// codes (<= 44 bits) go into the 64-bit accumulator between stores.
void huf_encode_stream(const HufC& h, const uint8_t* s, size_t n, std::vector<uint8_t>& out) {
  size_t base = out.size();
  out.resize(base + n * 12 / 8 + 16);
  uint8_t* p = out.data() + base;
  uint64_t acc = 0;
  int nb = 0;
  size_t i = n;
  while (i >= 4) {
    for (int k = 0; k < 4; k++) {
      uint8_t c = s[--i];
      acc |= uint64_t(h.code[c]) << nb;
      nb += h.len[c];
    }
    memcpy(p, &acc, 8);
    int bytes = nb >> 3;
    p += bytes;
    acc >>= 8 * bytes;
    nb &= 7;
  }
  while (i > 0) {
    uint8_t c = s[--i];
    acc |= uint64_t(h.code[c]) << nb;
    nb += h.len[c];
  }
  acc |= uint64_t(1) << nb;  // the end marker
  memcpy(p, &acc, 8);
  p += (nb + 8) >> 3;
  out.resize(size_t(p - out.data()));
}

// ---------------------------------------------------------- zstd tables

constexpr uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,    20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,    41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
constexpr size_t ZSTD_BLOCK_MAX = 128 * 1024;
constexpr uint32_t ZSTD_MAGIC = 0xFD2FB528u;

// -------------------------------------------------------- zstd decoding

struct ZFrameState {
  HufD huf;
  bool have_huf = false;
  FseD ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

// Decodes the literals section; sets *lit / *nlit. Returns bytes taken.
size_t zstd_literals(const uint8_t* src, size_t len, ZFrameState& st, const uint8_t** lit,
                     size_t* nlit) {
  need(len >= 1);
  int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  if (type <= 1) {
    size_t hs, n;
    if ((fmt & 1) == 0) {
      hs = 1;
      n = src[0] >> 3;
    } else if (fmt == 1) {
      hs = 2;
      need(len >= 2);
      n = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      hs = 3;
      need(len >= 3);
      n = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    need(n <= ZSTD_BLOCK_MAX);
    if (type == 0) {
      need(hs + n <= len);
      *lit = src + hs;
      *nlit = n;
      return hs + n;
    }
    need(hs + 1 <= len);
    st.lits.assign(n, src[hs]);
    *lit = st.lits.data();
    *nlit = n;
    return hs + 1;
  }
  size_t hs = fmt <= 1 ? 3 : fmt == 2 ? 4 : 5;
  int sbits = fmt <= 1 ? 10 : fmt == 2 ? 14 : 18;
  need(len >= hs);
  uint64_t h = 0;
  for (size_t i = 0; i < hs; i++) h |= uint64_t(src[i]) << (8 * i);
  size_t regen = size_t((h >> 4) & ((1u << sbits) - 1));
  size_t csize = size_t((h >> (4 + sbits)) & ((1u << sbits) - 1));
  bool single = fmt == 0;
  need(regen <= ZSTD_BLOCK_MAX && hs + csize <= len);
  const uint8_t* p = src + hs;
  size_t rem = csize;
  if (type == 2) {
    size_t used = huf_read_table(p, rem, st.huf);
    p += used;
    rem -= used;
    st.have_huf = true;
  } else {
    need(st.have_huf);
  }
  st.lits.resize(regen);
  uint8_t* out = st.lits.data();
  if (single) {
    huf_decode_streams(st.huf, &p, &rem, &out, &regen, 1);
  } else {
    need(rem >= 6);
    size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    need(s1 + s2 + s3 <= rem - 6);
    size_t seg = (regen + 3) / 4;
    need(3 * seg <= regen);
    const uint8_t* q = p + 6;
    const uint8_t* srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
    size_t lens[4] = {s1, s2, s3, rem - 6 - s1 - s2 - s3};
    uint8_t* outs[4] = {out, out + seg, out + 2 * seg, out + 3 * seg};
    size_t ns[4] = {seg, seg, seg, regen - 3 * seg};
    huf_decode_streams(st.huf, srcs, lens, outs, ns, 4);
  }
  *lit = out;
  *nlit = regen;
  return hs + csize;
}

size_t zstd_seq_table(const uint8_t* p, size_t len, int mode, FseD& t, bool& have,
                      const int16_t* def, int ndef, int defal, int maxal, int maxsym) {
  switch (mode) {
    case 0:
      fse_build_d(t, def, ndef, defal);
      have = true;
      return 0;
    case 1:
      need(len >= 1 && p[0] <= maxsym);
      fse_rle_d(t, p[0]);
      have = true;
      return 1;
    case 2: {
      int16_t norm[256];
      int nsym, al;
      size_t used = fse_read_ncount(p, len, norm, &nsym, &al, maxal, maxsym);
      fse_build_d(t, norm, nsym, al);
      have = true;
      return used;
    }
    default:
      need(have);
      return 0;
  }
}

// Decodes one compressed block into out[pos, cap); returns its size.
size_t zstd_block(const uint8_t* src, size_t len, ZFrameState& st, uint8_t* out,
                  size_t frame_start, size_t pos, size_t cap) {
  const uint8_t* lit;
  size_t nlit;
  size_t used = zstd_literals(src, len, st, &lit, &nlit);
  const uint8_t* p = src + used;
  size_t rem = len - used;
  need(rem >= 1);
  size_t nseq = p[0];
  if (nseq < 128) {
    p += 1;
    rem -= 1;
  } else if (nseq < 255) {
    need(rem >= 2);
    nseq = ((nseq - 128) << 8) + p[1];
    p += 2;
    rem -= 2;
  } else {
    need(rem >= 3);
    nseq = rd16(p + 1) + 0x7F00;
    p += 3;
    rem -= 3;
  }
  size_t limit = std::min(cap, pos + ZSTD_BLOCK_MAX);
  size_t op = pos, li = 0;
  if (nseq > 0) {
    need(rem >= 1);
    int modes = p[0];
    need((modes & 3) == 0);
    p++;
    rem--;
    size_t k = zstd_seq_table(p, rem, modes >> 6, st.ll, st.have_ll, LL_DEFAULT, 36, 6, 9, 35);
    p += k;
    rem -= k;
    k = zstd_seq_table(p, rem, (modes >> 4) & 3, st.of, st.have_of, OF_DEFAULT, 29, 5, 8, 31);
    p += k;
    rem -= k;
    k = zstd_seq_table(p, rem, (modes >> 2) & 3, st.ml, st.have_ml, ML_DEFAULT, 53, 6, 9, 52);
    p += k;
    rem -= k;
    BwdBits br;
    br.init(p, rem);
    uint32_t sll = br.read(st.ll.al), sof = br.read(st.of.al), sml = br.read(st.ml.al);
    for (size_t n = 0; n < nseq; n++) {
      int llc = st.ll.sym[sll], ofc = st.of.sym[sof], mlc = st.ml.sym[sml];
      need(ofc <= 31);
      uint32_t ofv = (1u << ofc) + br.read(ofc);
      size_t ml = ML_BASE[mlc] + br.read(ML_BITS[mlc]);
      size_t ll = LL_BASE[llc] + br.read(LL_BITS[llc]);
      uint32_t off;
      if (ofv > 3) {
        off = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = off;
      } else {
        uint32_t idx = ofv - 1 + (ll == 0);
        if (idx == 0) {
          off = st.rep[0];
        } else {
          off = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = off;
        }
      }
      if (n + 1 < nseq) {
        sll = st.ll.base[sll] + br.read(st.ll.nb[sll]);
        sml = st.ml.base[sml] + br.read(st.ml.nb[sml]);
        sof = st.of.base[sof] + br.read(st.of.nb[sof]);
      }
      need(ll <= nlit - li);
      need(ll + ml <= limit - op, op + ll + ml > cap ? E_OVERRUN : E_CORRUPT);
      memcpy(out + op, lit + li, ll);
      op += ll;
      li += ll;
      need(off > 0 && off <= op - frame_start);
      copy_match(out + op, off, ml);
      op += ml;
    }
    need(br.pos == 0);
  }
  size_t tail = nlit - li;
  need(tail <= limit - op, op + tail > cap ? E_OVERRUN : E_CORRUPT);
  memcpy(out + op, lit + li, tail);
  op += tail;
  return op - pos;
}

// Decodes every frame of src into out; returns the bytes written.
size_t zstd_decode(const uint8_t* src, size_t len, uint8_t* out, size_t cap) {
  size_t ip = 0, op = 0;
  need(len >= 4, E_MAGIC);
  ZFrameState st;
  while (ip < len) {
    need(len - ip >= 4);
    uint32_t magic = rd32(src + ip);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      need(len - ip >= 8);
      size_t sz = rd32(src + ip + 4);
      need(sz <= len - ip - 8);
      ip += 8 + sz;
      continue;
    }
    need(magic == ZSTD_MAGIC, op == 0 ? E_MAGIC : E_CORRUPT);
    ip += 4;
    need(ip < len);
    uint8_t fhd = src[ip++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    need((fhd & 8) == 0);
    int dsize = (fhd & 3) == 3 ? 4 : (fhd & 3);
    if (!single) {
      need(ip < len);
      ip++;  // window descriptor: the output buffer bounds every offset
    }
    need(len - ip >= size_t(dsize));
    uint32_t dict = 0;
    for (int i = 0; i < dsize; i++) dict |= uint32_t(src[ip + i]) << (8 * i);
    ip += dsize;
    need(dict == 0, E_DICT);
    int fsize = fcs_flag == 0 ? single : (1 << fcs_flag);
    need(len - ip >= size_t(fsize));
    uint64_t fcs = 0;
    for (int i = 0; i < fsize; i++) fcs |= uint64_t(src[ip + i]) << (8 * i);
    if (fsize == 2) fcs += 256;
    ip += fsize;
    size_t start = op;
    st = ZFrameState();
    for (;;) {
      need(len - ip >= 3);
      uint32_t bh = rd24(src + ip);
      ip += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      need(bsize <= ZSTD_BLOCK_MAX && type != 3);
      if (type == 0) {
        need(bsize <= len - ip);
        need(bsize <= cap - op, E_OVERRUN);
        memcpy(out + op, src + ip, bsize);
        ip += bsize;
        op += bsize;
      } else if (type == 1) {
        need(ip < len);
        need(bsize <= cap - op, E_OVERRUN);
        memset(out + op, src[ip], bsize);
        ip += 1;
        op += bsize;
      } else {
        need(bsize <= len - ip);
        op += zstd_block(src + ip, bsize, st, out, start, op, cap);
        ip += bsize;
      }
      if (last) break;
    }
    if (fcs_flag != 0 || single) need(op - start == fcs);
    if (checksum) {
      need(len - ip >= 4);
      uint32_t want = rd32(src + ip);
      ip += 4;
      need(uint32_t(xxh64(out + start, op - start, 0)) == want, E_CHECKSUM);
    }
  }
  return op;
}

// -------------------------------------------------------------- LZ77

struct Seq {
  uint32_t ll, ml, off;
};

inline size_t match_len(const uint8_t* a, const uint8_t* b, const uint8_t* limit) {
  const uint8_t* s = a;
  while (a + 8 <= limit) {
    uint64_t x = rd64(a) ^ rd64(b);
    if (x) return size_t(a - s) + (__builtin_ctzll(x) >> 3);
    a += 8;
    b += 8;
  }
  while (a < limit && *a == *b) a++, b++;
  return size_t(a - s);
}

// Hash-chain match finder over one input. `depth` candidates are tried at
// each position; `lazy` also tries the next position before taking one.
struct LZ {
  const uint8_t* src;
  size_t n;
  int hlog;
  std::vector<int32_t> head;
  std::unique_ptr<int32_t[]> chain;  // written before it is read
  size_t cmask, next = 0, max_dist, max_len;
  int depth;
  bool lazy;
  LZ(const uint8_t* s, size_t len, size_t maxdist, size_t maxlen, int dep, bool lz)
      : src(s), n(len), max_len(maxlen), depth(dep), lazy(lz) {
    int lg = 10;
    while (lg < 20 && (size_t(1) << lg) < len) lg++;
    hlog = std::max(10, std::min(lg - 3, 16));
    head.assign(size_t(1) << hlog, -1);
    int clog = depth > 1 ? lg : 0;
    chain.reset(new int32_t[size_t(1) << clog]);
    cmask = (size_t(1) << clog) - 1;
    max_dist = std::min(maxdist, depth > 1 ? cmask : size_t(INT32_MAX));
  }
  // A far match must be longer to pay for its offset's bits.
  static inline size_t min_len(size_t off) { return off < 1024 ? 4 : off < 65536 ? 5 : 6; }
  inline uint32_t hash(size_t i) const { return (rd32(src + i) * 2654435761u) >> (32 - hlog); }
  inline void insert_to(size_t target) {
    for (; next < target; next++) {
      if (next + 4 > n) continue;
      uint32_t h = hash(next);
      if (depth > 1) chain[next & cmask] = head[h];
      head[h] = int32_t(next);
    }
  }
  // Longest match at i (ending by `end`, at least 4 bytes), or length 0.
  size_t find(size_t i, size_t end, uint32_t rep0, size_t* off) {
    insert_to(i);
    const uint8_t* lim = src + (end - i > max_len ? i + max_len : end);
    size_t best = 0;
    if (rep0 && rep0 <= i && rep0 <= max_dist) {
      size_t l = match_len(src + i, src + i - rep0, lim);
      if (l >= 4) {
        best = l;
        *off = rep0;
        if (src + i + l >= lim) return best;
      }
    }
    int32_t c = head[hash(i)];
    for (int d = 0; d < depth && c >= 0; d++) {
      size_t cand = size_t(c);
      if (cand >= i || i - cand > max_dist) break;
      if (src[cand + best] == src[i + best] || best == 0) {
        size_t l = match_len(src + i, src + cand, lim);
        if (l > best && l >= min_len(i - cand)) {
          best = l;
          *off = i - cand;
          if (src + i + l >= lim) break;
        }
      }
      if (depth == 1) break;
      int32_t c2 = chain[cand & cmask];
      if (c2 >= c) break;
      c = c2;
    }
    return best >= 4 ? best : 0;
  }
  // Parses [begin, end): matches start before `start_limit`. Returns the
  // literal count after the last match.
  size_t parse(size_t begin, size_t end, size_t start_limit, std::vector<Seq>& out,
               uint32_t& rep0, int skip_shift) {
    size_t i = begin, anchor = begin;
    while (i < start_limit) {
      size_t off = 0, len = find(i, end, rep0, &off);
      if (!len) {
        // a probed position is always inserted; the ones a step skips
        // are not
        size_t step = 1 + ((i - anchor) >> skip_shift);
        insert_to(i + 1);
        i += step;
        next = std::max(next, i);
        continue;
      }
      if (lazy && i + 1 < start_limit) {
        size_t off2 = 0, len2 = find(i + 1, end, rep0, &off2);
        if (len2 > len + (off2 > off ? 1 : 0)) {
          i++;
          len = len2;
          off = off2;
        }
      }
      while (i > anchor && i > off && src[i - 1] == src[i - 1 - off] && len < max_len) {
        i--;
        len++;
      }
      out.push_back({uint32_t(i - anchor), uint32_t(len), uint32_t(off)});
      rep0 = uint32_t(off);
      i += len;
      anchor = i;
      if (depth > 1)
        insert_to(std::min(i, n));
      else
        next = std::max(next, i - 2);
    }
    return end - anchor;
  }
};

struct Effort {
  int depth;
  bool lazy;
  int skip_shift;
};
Effort zstd_effort(int level) {
  if (level <= 1) return {2, false, 5};
  if (level <= 3) return {4, false, 6};
  if (level <= 6) return {6, true, 7};
  if (level <= 9) return {8, true, 8};
  if (level <= 15) return {32, true, 10};
  return {128, true, 12};
}

// -------------------------------------------------------- zstd encoding

inline int ll_code(uint32_t ll) {
  if (ll < 16) return int(ll);
  int c = 35;
  while (LL_BASE[c] > ll) c--;
  return c;
}
inline int ml_code(uint32_t ml) {
  if (ml < 35) return int(ml - 3);
  int c = 52;
  while (ML_BASE[c] > ml) c--;
  return c;
}

void put_literals_header_raw(std::vector<uint8_t>& o, size_t n, int type) {
  if (n < 32) {
    o.push_back(uint8_t((n << 3) | type));
  } else if (n < 4096) {
    o.push_back(uint8_t(((n & 15) << 4) | (1 << 2) | type));
    o.push_back(uint8_t(n >> 4));
  } else {
    o.push_back(uint8_t(((n & 15) << 4) | (3 << 2) | type));
    o.push_back(uint8_t(n >> 4));
    o.push_back(uint8_t(n >> 12));
  }
}

void zstd_encode_literals(const uint8_t* lit, size_t n, std::vector<uint8_t>& o) {
  bool same = n > 0;
  for (size_t i = 1; i < n && same; i++) same = lit[i] == lit[0];
  if (same && n > 1) {
    put_literals_header_raw(o, n, 1);
    o.push_back(lit[0]);
    return;
  }
  if (n >= 32) {
    uint32_t counts[256] = {0};
    for (size_t i = 0; i < n; i++) counts[lit[i]]++;
    HufC h;
    huf_build(counts, h, 11);
    std::vector<uint8_t> body;
    if (huf_write_table(h, body)) {
      bool single = n <= 1023;
      if (single) {
        huf_encode_stream(h, lit, n, body);
      } else {
        size_t seg = (n + 3) / 4, jt = body.size();
        body.resize(jt + 6);
        size_t sizes[3];
        for (int s = 0; s < 4; s++) {
          size_t a = s * seg, b = s < 3 ? a + seg : n, before = body.size();
          huf_encode_stream(h, lit + a, b - a, body);
          if (s < 3) sizes[s] = body.size() - before;
        }
        for (int s = 0; s < 3; s++) {
          need(sizes[s] <= 0xFFFF, E_ARG);
          body[jt + 2 * s] = uint8_t(sizes[s]);
          body[jt + 2 * s + 1] = uint8_t(sizes[s] >> 8);
        }
      }
      size_t c = body.size();
      int fmt, sbits;
      size_t hs;
      if (single) {
        fmt = 0, sbits = 10, hs = 3;
      } else if (n < 1024 && c < 1024) {
        fmt = 1, sbits = 10, hs = 3;
      } else if (n < 16384 && c < 16384) {
        fmt = 2, sbits = 14, hs = 4;
      } else {
        fmt = 3, sbits = 18, hs = 5;
      }
      size_t raw_cost = n + (n < 32 ? 1 : n < 4096 ? 2 : 3);
      if (c < (size_t(1) << sbits) && hs + c < raw_cost) {
        uint64_t hv = 2 | (uint64_t(fmt) << 2) | (uint64_t(n) << 4) | (uint64_t(c) << (4 + sbits));
        for (size_t i = 0; i < hs; i++) o.push_back(uint8_t(hv >> (8 * i)));
        o.insert(o.end(), body.begin(), body.end());
        return;
      }
    }
  }
  put_literals_header_raw(o, n, 0);
  o.insert(o.end(), lit, lit + n);
}

struct ZTables {
  FseC ll, of, ml;
  ZTables() {
    fse_build_c(ll, LL_DEFAULT, 36, 6);
    fse_build_c(of, OF_DEFAULT, 29, 5);
    fse_build_c(ml, ML_DEFAULT, 53, 6);
  }
};

// A compressed block body for block [bs, be) and its sequences; `rep` is
// updated as the decoder will update it.
void zstd_encode_block(const uint8_t* src, size_t bs, size_t be, const std::vector<Seq>& seqs,
                       size_t nseq0, size_t nseq1, const ZTables& zt, uint32_t* rep,
                       std::vector<uint8_t>& lits, std::vector<uint8_t>& o) {
  lits.clear();
  size_t p = bs;
  for (size_t k = nseq0; k < nseq1; k++) {
    lits.insert(lits.end(), src + p, src + p + seqs[k].ll);
    p += seqs[k].ll + seqs[k].ml;
  }
  lits.insert(lits.end(), src + p, src + be);
  zstd_encode_literals(lits.data(), lits.size(), o);
  size_t nseq = nseq1 - nseq0;
  if (nseq < 128) {
    o.push_back(uint8_t(nseq));
  } else if (nseq < 0x7F00) {
    o.push_back(uint8_t((nseq >> 8) + 128));
    o.push_back(uint8_t(nseq));
  } else {
    o.push_back(255);
    o.push_back(uint8_t(nseq - 0x7F00));
    o.push_back(uint8_t((nseq - 0x7F00) >> 8));
  }
  if (!nseq) return;
  o.push_back(0);  // predefined tables for all three
  std::vector<uint32_t> ofv(nseq);
  for (size_t k = 0; k < nseq; k++) {
    const Seq& s = seqs[nseq0 + k];
    if (s.ll > 0 && s.off == rep[0]) {
      ofv[k] = 1;
    } else {
      ofv[k] = s.off + 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = s.off;
    }
  }
  BitW w(o);
  auto codes = [&](size_t k, int& llc, int& mlc, int& ofc) {
    const Seq& s = seqs[nseq0 + k];
    llc = ll_code(s.ll);
    mlc = ml_code(s.ml);
    ofc = highbit(ofv[k]);
  };
  auto extra = [&](size_t k, int llc, int mlc, int ofc) {
    const Seq& s = seqs[nseq0 + k];
    w.add(s.ll - LL_BASE[llc], LL_BITS[llc]);
    w.add(s.ml - ML_BASE[mlc], ML_BITS[mlc]);
    w.add(ofv[k], ofc);
  };
  int llc, mlc, ofc;
  codes(nseq - 1, llc, mlc, ofc);
  need(ofc <= 28, E_ARG);
  uint32_t sml = fse_init_state(zt.ml, mlc), sof = fse_init_state(zt.of, ofc),
           sll = fse_init_state(zt.ll, llc);
  extra(nseq - 1, llc, mlc, ofc);
  for (size_t k = nseq - 1; k-- > 0;) {
    codes(k, llc, mlc, ofc);
    need(ofc <= 28, E_ARG);
    fse_encode(w, zt.of, sof, ofc);
    fse_encode(w, zt.ml, sml, mlc);
    fse_encode(w, zt.ll, sll, llc);
    extra(k, llc, mlc, ofc);
  }
  w.add(sml, zt.ml.al);
  w.add(sof, zt.of.al);
  w.add(sll, zt.ll.al);
  w.close();
}

void zstd_encode(const uint8_t* src, size_t n, int level, bool checksum, std::vector<uint8_t>& o) {
  o.clear();
  for (int i = 0; i < 4; i++) o.push_back(uint8_t(ZSTD_MAGIC >> (8 * i)));
  int fcs_flag = n < 256 ? 0 : n < 65536 + 256 ? 1 : n <= 0xFFFFFFFFu ? 2 : 3;
  o.push_back(uint8_t((fcs_flag << 6) | (1 << 5) | (checksum ? 4 : 0)));
  uint64_t fv = fcs_flag == 1 ? n - 256 : n;
  int fsize = fcs_flag == 0 ? 1 : (1 << fcs_flag);
  for (int i = 0; i < fsize; i++) o.push_back(uint8_t(fv >> (8 * i)));
  if (n == 0) {
    o.push_back(1);
    o.push_back(0);
    o.push_back(0);
  }
  Effort ef = zstd_effort(level);
  LZ lz(src, n, size_t(1) << 22, ZSTD_BLOCK_MAX, ef.depth, ef.lazy);
  ZTables zt;
  std::vector<Seq> seqs;
  std::vector<uint8_t> lits, body;
  uint32_t rep[3] = {1, 4, 8}, rep0 = 0;
  for (size_t bs = 0; bs < n; bs += ZSTD_BLOCK_MAX) {
    size_t be = std::min(n, bs + ZSTD_BLOCK_MAX), bl = be - bs;
    bool last = be == n;
    bool same = true;
    for (size_t i = bs + 1; i < be && same; i++) same = src[i] == src[bs];
    uint32_t hdr;
    if (same && bl > 1) {
      hdr = uint32_t(last) | (1u << 1) | uint32_t(bl << 3);
      for (int i = 0; i < 3; i++) o.push_back(uint8_t(hdr >> (8 * i)));
      o.push_back(src[bs]);
      lz.next = std::max(lz.next, be);
      continue;
    }
    seqs.clear();
    size_t start_limit = bl > 12 ? be - 8 : bs;
    lz.parse(bs, be, start_limit, seqs, rep0, ef.skip_shift);
    body.clear();
    uint32_t rep_new[3] = {rep[0], rep[1], rep[2]};
    zstd_encode_block(src, bs, be, seqs, 0, seqs.size(), zt, rep_new, lits, body);
    if (body.size() < bl) {
      memcpy(rep, rep_new, sizeof rep);
      hdr = uint32_t(last) | (2u << 1) | uint32_t(body.size() << 3);
      for (int i = 0; i < 3; i++) o.push_back(uint8_t(hdr >> (8 * i)));
      o.insert(o.end(), body.begin(), body.end());
    } else {
      hdr = uint32_t(last) | uint32_t(bl << 3);
      for (int i = 0; i < 3; i++) o.push_back(uint8_t(hdr >> (8 * i)));
      o.insert(o.end(), src + bs, src + be);
    }
  }
  if (checksum) {
    uint32_t x = uint32_t(xxh64(src, n, 0));
    for (int i = 0; i < 4; i++) o.push_back(uint8_t(x >> (8 * i)));
  }
}

// ------------------------------------------------------------------ LZ4

size_t lz4_decode(const uint8_t* src, size_t len, uint8_t* out, size_t cap) {
  size_t ip = 0, op = 0;
  need(len > 0);
  for (;;) {
    need(ip < len);
    uint8_t tok = src[ip++];
    size_t lit = tok >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        need(ip < len);
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    need(lit <= len - ip);
    need(lit <= cap - op, E_OVERRUN);
    memcpy(out + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip == len) break;
    need(len - ip >= 2);
    size_t off = rd16(src + ip);
    ip += 2;
    need(off > 0 && off <= op);
    size_t ml = tok & 15;
    if (ml == 15) {
      uint8_t b;
      do {
        need(ip < len);
        b = src[ip++];
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    need(ml <= cap - op, E_OVERRUN);
    copy_match(out + op, off, ml);
    op += ml;
  }
  return op;
}

void lz4_put_len(std::vector<uint8_t>& o, size_t v) {
  while (v >= 255) {
    o.push_back(255);
    v -= 255;
  }
  o.push_back(uint8_t(v));
}

void lz4_encode(const uint8_t* src, size_t n, int level, std::vector<uint8_t>& o) {
  o.clear();
  std::vector<Seq> seqs;
  size_t tail = n;
  if (n >= 13) {
    Effort ef = level >= 9 ? Effort{64, true, 10} : level >= 5 ? Effort{8, false, 6}
                                                               : Effort{1, false, 5};
    LZ lz(src, n, 65535, SIZE_MAX, ef.depth, ef.lazy);
    uint32_t rep0 = 0;
    tail = lz.parse(0, n - 5, n - 12, seqs, rep0, ef.skip_shift) + 5;
  }
  size_t p = 0;
  for (const Seq& s : seqs) {
    size_t ml = s.ml - 4;
    o.push_back(uint8_t((std::min<size_t>(s.ll, 15) << 4) | std::min<size_t>(ml, 15)));
    if (s.ll >= 15) lz4_put_len(o, s.ll - 15);
    o.insert(o.end(), src + p, src + p + s.ll);
    p += s.ll + s.ml;
    o.push_back(uint8_t(s.off));
    o.push_back(uint8_t(s.off >> 8));
    if (ml >= 15) lz4_put_len(o, ml - 15);
  }
  o.push_back(uint8_t(std::min<size_t>(tail, 15) << 4));
  if (tail >= 15) lz4_put_len(o, tail - 15);
  o.insert(o.end(), src + p, src + n);
}

// -------------------------------------------------------------- BloscLZ

size_t blosclz_decode(const uint8_t* src, size_t len, uint8_t* out, size_t cap) {
  const size_t MAX_DISTANCE = 8191;
  if (len == 0) return 0;
  size_t ip = 0, op = 0;
  uint32_t ctrl = src[ip++] & 31u;
  for (;;) {
    if (ctrl >= 32) {
      size_t ml = (ctrl >> 5) - 1;
      size_t ofs = size_t(ctrl & 31u) << 8;
      if (ml == 6) {
        uint8_t code;
        do {
          need(ip < len);
          code = src[ip++];
          ml += code;
        } while (code == 255);
      }
      need(ip < len);
      uint8_t code = src[ip++];
      ml += 3;
      size_t dist = ofs + code;
      if (code == 255 && ofs == (31u << 8)) {
        need(len - ip >= 2);
        dist = (size_t(src[ip]) << 8) + src[ip + 1] + MAX_DISTANCE;
        ip += 2;
      }
      dist += 1;
      need(ml <= cap - op, E_OVERRUN);
      need(dist <= op);
      copy_match(out + op, dist, ml);
      op += ml;
    } else {
      size_t lit = ctrl + 1;
      need(lit <= cap - op, E_OVERRUN);
      need(lit <= len - ip);
      memcpy(out + op, src + ip, lit);
      op += lit;
      ip += lit;
    }
    if (ip >= len) break;
    ctrl = src[ip++];
  }
  return op;
}

// ------------------------------------------------------------ zlib/deflate

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = std::min<size_t>(n, 5552);
    n -= k;
    for (size_t i = 0; i < k; i++) {
      a += p[i];
      b += a;
    }
    p += k;
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

constexpr uint16_t LEN_BASE[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                   31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t LEN_EXTRA[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                   2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t DIST_BASE[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
constexpr uint8_t DIST_EXTRA[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

struct Inflate {
  const uint8_t* src;
  size_t len, ip = 0;
  uint32_t acc = 0;
  int cnt = 0;
  uint8_t* out;
  size_t cap, op = 0;
  struct Huff {
    uint16_t count[16], sym[288];
  };
  uint32_t bits(int need_bits) {
    while (cnt < need_bits) {
      need(ip < len);
      acc |= uint32_t(src[ip++]) << cnt;
      cnt += 8;
    }
    uint32_t v = acc & ((1u << need_bits) - 1);
    acc >>= need_bits;
    cnt -= need_bits;
    return v;
  }
  static void build(Huff& h, const uint8_t* lens, int n) {
    memset(h.count, 0, sizeof h.count);
    for (int i = 0; i < n; i++) h.count[lens[i]]++;
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left = (left << 1) - h.count[l];
      need(left >= 0);
    }
    uint16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + h.count[l];
    for (int i = 0; i < n; i++)
      if (lens[i]) h.sym[offs[lens[i]]++] = uint16_t(i);
  }
  int decode(const Huff& h) {
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; l++) {
      code |= int(bits(1));
      int count = h.count[l];
      if (code - count < first) return h.sym[index + (code - first)];
      index += count;
      first = (first + count) << 1;
      code <<= 1;
    }
    fail(E_CORRUPT);
  }
  void codes(const Huff& lc, const Huff& dc) {
    for (;;) {
      int s = decode(lc);
      if (s < 256) {
        need(op < cap, E_OVERRUN);
        out[op++] = uint8_t(s);
      } else if (s == 256) {
        return;
      } else {
        s -= 257;
        need(s < 29);
        size_t l = LEN_BASE[s] + bits(LEN_EXTRA[s]);
        int d = decode(dc);
        need(d < 30);
        size_t dist = DIST_BASE[d] + bits(DIST_EXTRA[d]);
        need(dist <= op);
        need(l <= cap - op, E_OVERRUN);
        copy_match(out + op, dist, l);
        op += l;
      }
    }
  }
  void run() {
    need(len >= 6);
    uint32_t cmf = src[0], flg = src[1];
    need((cmf & 15) == 8 && ((cmf << 8) | flg) % 31 == 0 && !(flg & 0x20), E_MAGIC);
    ip = 2;
    int last;
    do {
      last = int(bits(1));
      int type = int(bits(2));
      if (type == 0) {
        acc = 0;
        cnt = 0;
        need(len - ip >= 4);
        uint32_t n = rd16(src + ip), nn = rd16(src + ip + 2);
        ip += 4;
        need(n == (~nn & 0xFFFF) && n <= len - ip);
        need(n <= cap - op, E_OVERRUN);
        memcpy(out + op, src + ip, n);
        ip += n;
        op += n;
      } else if (type == 1) {
        uint8_t l[288];
        for (int i = 0; i < 288; i++) l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        Huff lc, dc;
        build(lc, l, 288);
        for (int i = 0; i < 30; i++) l[i] = 5;
        build(dc, l, 30);
        codes(lc, dc);
      } else if (type == 2) {
        int nlen = int(bits(5)) + 257, ndist = int(bits(5)) + 1, ncode = int(bits(4)) + 4;
        need(nlen <= 286 && ndist <= 30);
        static constexpr uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                              11, 4,  12, 3, 13, 2, 14, 1, 15};
        uint8_t l[320] = {0};
        for (int i = 0; i < ncode; i++) l[order[i]] = uint8_t(bits(3));
        Huff cc, lc, dc;
        build(cc, l, 19);
        memset(l, 0, sizeof l);
        int i = 0;
        while (i < nlen + ndist) {
          int s = decode(cc);
          if (s < 16) {
            l[i++] = uint8_t(s);
            continue;
          }
          int rep, val = 0;
          if (s == 16) {
            need(i > 0);
            val = l[i - 1];
            rep = 3 + int(bits(2));
          } else if (s == 17) {
            rep = 3 + int(bits(3));
          } else {
            rep = 11 + int(bits(7));
          }
          need(i + rep <= nlen + ndist);
          while (rep--) l[i++] = uint8_t(val);
        }
        need(l[256] != 0);
        build(lc, l, nlen);
        build(dc, l + nlen, ndist);
        codes(lc, dc);
      } else {
        fail(E_CORRUPT);
      }
    } while (!last);
    acc = 0;
    cnt = 0;
    need(len - ip >= 4);
    uint32_t want = (uint32_t(src[ip]) << 24) | (uint32_t(src[ip + 1]) << 16) |
                    (uint32_t(src[ip + 2]) << 8) | src[ip + 3];
    need(adler32(out, op) == want, E_CHECKSUM);
  }
};

size_t zlib_decode(const uint8_t* src, size_t len, uint8_t* out, size_t cap) {
  Inflate z{src, len, 0, 0, 0, out, cap, 0};
  z.run();
  return z.op;
}

inline uint32_t reverse_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) r |= ((v >> i) & 1u) << (n - 1 - i);
  return r;
}

// One final fixed-Huffman deflate block inside a zlib wrapper.
void zlib_encode(const uint8_t* src, size_t n, int level, std::vector<uint8_t>& o) {
  o.clear();
  o.push_back(0x78);
  o.push_back(0x9C);
  std::vector<Seq> seqs;
  if (n >= 12) {
    Effort ef = zstd_effort(level);
    LZ lz(src, n, 32768, 258, ef.depth, ef.lazy);
    uint32_t rep0 = 0;
    lz.parse(0, n, n - 4, seqs, rep0, ef.skip_shift);
  }
  BitW w(o);
  w.add(1, 1);
  w.add(1, 2);
  auto lit = [&](uint32_t v) {
    if (v < 144)
      w.add(reverse_bits(0x30 + v, 8), 8);
    else if (v < 256)
      w.add(reverse_bits(0x190 + v - 144, 9), 9);
    else if (v < 280)
      w.add(reverse_bits(v - 256, 7), 7);
    else
      w.add(reverse_bits(0xC0 + v - 280, 8), 8);
  };
  size_t p = 0;
  for (const Seq& s : seqs) {
    for (size_t i = 0; i < s.ll; i++) lit(src[p + i]);
    p += s.ll + s.ml;
    int lc = 28;
    while (LEN_BASE[lc] > s.ml) lc--;
    lit(257 + lc);
    w.add(s.ml - LEN_BASE[lc], LEN_EXTRA[lc]);
    int dc = 29;
    while (DIST_BASE[dc] > s.off) dc--;
    w.add(reverse_bits(dc, 5), 5);
    w.add(s.off - DIST_BASE[dc], DIST_EXTRA[dc]);
  }
  for (size_t i = p; i < n; i++) lit(src[i]);
  lit(256);
  w.align();
  uint32_t a = adler32(src, n);
  for (int i = 3; i >= 0; i--) o.push_back(uint8_t(a >> (8 * i)));
}

// --------------------------------------------------------------- Snappy
//
// Google's Snappy block format (format_description.txt in the snappy
// sources): the uncompressed length as a little-endian base-128 varint,
// then elements whose tag byte's low two bits say what follows: 00 a
// literal (length - 1 in the tag's upper six bits, or in 1-4 bytes after it
// for the values 60-63), 01 a copy of 4-11 bytes with an 11-bit offset,
// 10 a copy of 1-64 bytes with a 16-bit offset, 11 one with a 32-bit offset.

size_t snappy_decode(const uint8_t* src, size_t len, uint8_t* out, size_t cap) {
  size_t ip = 0, ulen = 0;
  for (int shift = 0;; shift += 7) {
    need(ip < len && shift <= 28);
    uint8_t b = src[ip++];
    ulen |= size_t(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
  }
  need(ulen <= 0xFFFFFFFFu);
  need(ulen <= cap, E_OVERRUN);
  size_t op = 0;
  while (ip < len) {
    uint8_t tag = src[ip++];
    size_t n, off;
    if ((tag & 3) == 0) {
      n = tag >> 2;
      if (n >= 60) {
        size_t k = n - 59;
        need(len - ip >= k);
        n = 0;
        for (size_t j = 0; j < k; j++) n |= size_t(src[ip + j]) << (8 * j);
        ip += k;
      }
      n += 1;
      need(n <= len - ip && n <= ulen - op);
      memcpy(out + op, src + ip, n);
      ip += n;
      op += n;
      continue;
    }
    if ((tag & 3) == 1) {
      need(ip < len);
      n = 4 + ((tag >> 2) & 7);
      off = (size_t(tag >> 5) << 8) | src[ip++];
    } else if ((tag & 3) == 2) {
      need(len - ip >= 2);
      n = 1 + (tag >> 2);
      off = rd16(src + ip);
      ip += 2;
    } else {
      need(len - ip >= 4);
      n = 1 + (tag >> 2);
      off = rd32(src + ip);
      ip += 4;
    }
    need(off > 0 && off <= op && n <= ulen - op);
    copy_match(out + op, off, n);
    op += n;
  }
  need(op == ulen);
  return op;
}

inline size_t snappy_bound(size_t n) { return 32 + n + n / 6; }

void snappy_literal(const uint8_t* p, size_t n, std::vector<uint8_t>& o) {
  size_t v = n - 1;
  if (v < 60) {
    o.push_back(uint8_t(v << 2));
  } else {
    int k = v < (1u << 8) ? 1 : v < (1u << 16) ? 2 : v < (1u << 24) ? 3 : 4;
    o.push_back(uint8_t((59 + k) << 2));
    for (int j = 0; j < k; j++) o.push_back(uint8_t(v >> (8 * j)));
  }
  o.insert(o.end(), p, p + n);
}

// A copy of `n` >= 4 bytes from `off` <= 65535 back, as snappy's own
// encoder splits it: pieces of 64 while 68 or more are left (60 then, so
// that the last piece keeps at least 4), the short near ones in two bytes.
void snappy_copy(size_t off, size_t n, std::vector<uint8_t>& o) {
  auto copy2 = [&](size_t len) {
    o.push_back(uint8_t(((len - 1) << 2) | 2));
    o.push_back(uint8_t(off));
    o.push_back(uint8_t(off >> 8));
  };
  while (n >= 68) {
    copy2(64);
    n -= 64;
  }
  if (n > 64) {
    copy2(60);
    n -= 60;
  }
  if (n < 12 && off < 2048) {
    o.push_back(uint8_t(((off >> 8) << 5) | ((n - 4) << 2) | 1));
    o.push_back(uint8_t(off));
  } else {
    copy2(n);
  }
}

void snappy_encode(const uint8_t* src, size_t n, std::vector<uint8_t>& o) {
  o.clear();
  need(n <= 0xFFFFFFFFu, E_ARG);
  for (size_t v = n;; v >>= 7) {
    o.push_back(uint8_t((v & 0x7F) | (v >= 0x80 ? 0x80 : 0)));
    if (v < 0x80) break;
  }
  std::vector<Seq> seqs;
  size_t tail = n;
  if (n >= 8) {
    LZ lz(src, n, 65535, SIZE_MAX, 1, false);
    uint32_t rep0 = 0;
    tail = lz.parse(0, n, n - 3, seqs, rep0, 5);
  }
  size_t p = 0;
  for (const Seq& s : seqs) {
    if (s.ll) snappy_literal(src + p, s.ll, o);
    snappy_copy(s.off, s.ml, o);
    p += s.ll + s.ml;
  }
  if (tail) snappy_literal(src + p, tail, o);
}

// ---------------------------------------------------------------- Blosc

enum { BLOSCLZ = 0, LZ4 = 1, SNAPPY = 2, ZLIB = 3, ZSTD = 4 };
constexpr size_t BLOSC_OVERHEAD = 16, BLOSC_MIN_BUFFER = 128;

size_t blosc_stream_decode(int codec, const uint8_t* src, size_t len, uint8_t* out, size_t cap) {
  switch (codec) {
    case BLOSCLZ:
      return blosclz_decode(src, len, out, cap);
    case LZ4:
      return lz4_decode(src, len, out, cap);
    case ZLIB:
      return zlib_decode(src, len, out, cap);
    case ZSTD:
      return zstd_decode(src, len, out, cap);
    case SNAPPY:
      return snappy_decode(src, len, out, cap);
    default:
      fail(E_UNSUPPORTED);
  }
}

size_t blosc_decode(const uint8_t* src, size_t len, uint8_t* dst, size_t cap) {
  need(len >= BLOSC_OVERHEAD);
  need(src[0] >= 1 && src[0] <= 2, E_UNSUPPORTED);
  uint8_t flags = src[2];
  size_t ts = src[3], nbytes = rd32(src + 4), bsz = rd32(src + 8), cbytes = rd32(src + 12);
  need(cbytes >= BLOSC_OVERHEAD && cbytes <= len);
  need(nbytes <= cap, E_OVERRUN);
  if (nbytes == 0) return 0;
  if (flags & 0x02) {
    need(nbytes <= cbytes - BLOSC_OVERHEAD);
    memcpy(dst, src + BLOSC_OVERHEAD, nbytes);
    return nbytes;
  }
  int codec = flags >> 5;
  need(codec <= ZSTD, E_UNSUPPORTED);
  need(ts >= 1 && bsz >= 1);
  size_t nblocks = nbytes / bsz + (nbytes % bsz != 0);
  need(nblocks <= (cbytes - BLOSC_OVERHEAD) / 4);
  bool split_ok = !(flags & 0x10);
  int shuffle = (flags & 0x01) ? 1 : (flags & 0x04) ? 2 : 0;
  std::vector<uint8_t> tmp(shuffle ? std::min(bsz, nbytes) : 0);
  size_t first_data = BLOSC_OVERHEAD + 4 * nblocks;
  for (size_t j = 0; j < nblocks; j++) {
    bool leftover = j == nblocks - 1 && nbytes % bsz != 0;
    size_t bsize = leftover ? nbytes % bsz : bsz;
    size_t nstreams = split_ok && !leftover ? ts : 1;
    need(bsize % nstreams == 0);
    size_t neblock = bsize / nstreams;
    bool unshuffle = (shuffle == 1 && ts > 1) || (shuffle == 2 && bsize >= ts);
    uint8_t* out = unshuffle ? tmp.data() : dst + j * bsz;
    size_t pos = rd32(src + BLOSC_OVERHEAD + 4 * j);
    need(pos >= first_data && pos <= cbytes);
    for (size_t s = 0; s < nstreams; s++) {
      need(cbytes - pos >= 4);
      size_t csize = rd32(src + pos);
      pos += 4;
      need(csize <= cbytes - pos);
      if (csize == neblock) {
        memcpy(out + s * neblock, src + pos, neblock);
      } else {
        size_t got = blosc_stream_decode(codec, src + pos, csize, out + s * neblock, neblock);
        need(got == neblock);
      }
      pos += csize;
    }
    if (unshuffle) {
      if (shuffle == 1)
        unshuffle_bytes(tmp.data(), dst + j * bsz, bsize, ts);
      else
        bitunshuffle(tmp.data(), dst + j * bsz, bsize, ts);
    }
  }
  return nbytes;
}

// c-blosc 1.x compute_blocksize with its forward-compatible split rule.
size_t blosc_blocksize(int codec, bool hc, int clevel, size_t ts, size_t n, size_t forced) {
  const size_t L1 = 32 * 1024;
  if (n < ts) return 1;
  size_t bs = n;
  if (forced) {
    bs = std::max(forced, BLOSC_MIN_BUFFER);
  } else if (n >= L1) {
    bs = L1;
    bool hcr = codec == ZLIB || codec == ZSTD || hc;
    if (hcr) bs *= 2;
    switch (clevel) {
      case 0: bs /= 4; break;
      case 1: bs /= 2; break;
      case 2: break;
      case 3: bs *= 2; break;
      case 4:
      case 5: bs *= 4; break;
      case 6:
      case 7:
      case 8: bs *= 8; break;
      default:
        bs *= 8;
        if (hcr) bs *= 2;
    }
  }
  bool split = codec != ZSTD && ts <= 16 && bs / ts >= BLOSC_MIN_BUFFER;
  if (clevel > 0 && split) {
    bs = std::min<size_t>(bs, 1 << 18) * ts;
    bs = std::max<size_t>(bs, 1 << 16);
    bs = std::min<size_t>(bs, 1 << 20);
  }
  bs = std::min(bs, n);
  if (bs > ts) bs = bs / ts * ts;
  return bs;
}

size_t blosc_encode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, int codec, bool hc,
                    int clevel, int shuffle, size_t ts, size_t forced_bs) {
  need(cap >= n + BLOSC_OVERHEAD && ts >= 1 && ts <= 255 && clevel >= 0 && clevel <= 9 &&
           shuffle >= 0 && shuffle <= 2 && codec >= 0 && codec <= ZSTD &&
           n <= 0x7FFFFFF0u,
       E_ARG);
  size_t bsz = blosc_blocksize(codec, hc, clevel, ts, n, forced_bs);
  bool split = codec != ZSTD && ts <= 16 && bsz / ts >= BLOSC_MIN_BUFFER;
  uint8_t flags = uint8_t((shuffle == 1 ? 0x01 : shuffle == 2 ? 0x04 : 0) | (codec << 5));
  if (!split) flags |= 0x10;
  dst[0] = 2;
  dst[1] = 1;
  dst[3] = uint8_t(ts);
  wr32(dst + 4, uint32_t(n));
  wr32(dst + 8, uint32_t(bsz));
  auto memcpyed = [&]() {
    dst[2] = uint8_t(flags | 0x02);
    wr32(dst + 12, uint32_t(n + BLOSC_OVERHEAD));
    memcpy(dst + BLOSC_OVERHEAD, src, n);
    return n + BLOSC_OVERHEAD;
  };
  if (n < BLOSC_MIN_BUFFER || clevel == 0 || codec == BLOSCLZ) return memcpyed();
  size_t nblocks = n / bsz + (n % bsz != 0);
  size_t pos = BLOSC_OVERHEAD + 4 * nblocks;
  if (pos > cap) return memcpyed();
  std::vector<uint8_t> tmp(bsz), enc;
  for (size_t j = 0; j < nblocks; j++) {
    bool leftover = j == nblocks - 1 && n % bsz != 0;
    size_t bsize = leftover ? n % bsz : bsz;
    const uint8_t* in = src + j * bsz;
    if (shuffle == 1 && ts > 1) {
      shuffle_bytes(in, tmp.data(), bsize, ts);
      in = tmp.data();
    } else if (shuffle == 2) {
      bitshuffle(in, tmp.data(), bsize, ts);
      in = tmp.data();
    }
    wr32(dst + BLOSC_OVERHEAD + 4 * j, uint32_t(pos));
    size_t nstreams = split && !leftover ? ts : 1, neblock = bsize / nstreams;
    for (size_t s = 0; s < nstreams; s++) {
      const uint8_t* piece = in + s * neblock;
      if (codec == ZSTD)
        zstd_encode(piece, neblock, clevel * 2 - 1, false, enc);
      else if (codec == LZ4)
        lz4_encode(piece, neblock, hc ? 9 : clevel, enc);
      else if (codec == SNAPPY)
        snappy_encode(piece, neblock, enc);
      else
        zlib_encode(piece, neblock, clevel, enc);
      bool raw = enc.size() >= neblock;
      size_t k = raw ? neblock : enc.size();
      if (cap - pos < 4 + k || pos + 4 + k > n + BLOSC_OVERHEAD) return memcpyed();
      wr32(dst + pos, uint32_t(k));
      memcpy(dst + pos + 4, raw ? piece : enc.data(), k);
      pos += 4 + k;
    }
  }
  dst[2] = flags;
  wr32(dst + 12, uint32_t(pos));
  return pos;
}

}  // namespace

// -------------------------------------------------------------- C ABI

extern "C" {

int zc_abi_version() { return 2; }

int64_t zc_blosc_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t cap) {
  return guarded([&] { return int64_t(blosc_decode(src, size_t(len), dst, size_t(cap))); });
}

// codec: 0 blosclz, 1 lz4, 2 snappy, 3 zlib, 4 zstd; hc: lz4hc. dst holds
// n + 16.
int64_t zc_blosc_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int codec,
                        int hc, int clevel, int shuffle, int typesize, int64_t blocksize) {
  return guarded([&] {
    return int64_t(blosc_encode(src, size_t(n), dst, size_t(cap), codec, hc != 0, clevel,
                                shuffle, size_t(typesize), size_t(blocksize)));
  });
}

int64_t zc_zstd_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t cap) {
  return guarded([&] { return int64_t(zstd_decode(src, size_t(len), dst, size_t(cap))); });
}

// Worst case: the input in raw blocks plus frame and block headers.
int64_t zc_zstd_bound(int64_t n) { return n + 3 * (n / int64_t(ZSTD_BLOCK_MAX) + 1) + 18; }

int64_t zc_zstd_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int level,
                       int checksum) {
  return guarded([&] {
    std::vector<uint8_t> o;
    zstd_encode(src, size_t(n), level, checksum != 0, o);
    need(o.size() <= size_t(cap), E_OVERRUN);
    memcpy(dst, o.data(), o.size());
    return int64_t(o.size());
  });
}

int64_t zc_lz4_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t cap) {
  return guarded([&] { return int64_t(lz4_decode(src, size_t(len), dst, size_t(cap))); });
}

int64_t zc_blosclz_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t cap) {
  return guarded([&] { return int64_t(blosclz_decode(src, size_t(len), dst, size_t(cap))); });
}

int64_t zc_zlib_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t cap) {
  return guarded([&] { return int64_t(zlib_decode(src, size_t(len), dst, size_t(cap))); });
}

int64_t zc_snappy_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t cap) {
  return guarded([&] { return int64_t(snappy_decode(src, size_t(len), dst, size_t(cap))); });
}

int64_t zc_snappy_bound(int64_t n) { return int64_t(snappy_bound(size_t(n))); }

int64_t zc_snappy_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  return guarded([&] {
    std::vector<uint8_t> o;
    snappy_encode(src, size_t(n), o);
    need(o.size() <= size_t(cap), E_OVERRUN);
    memcpy(dst, o.data(), o.size());
    return int64_t(o.size());
  });
}

// mode: 0 byte shuffle, 1 byte unshuffle, 2 bitshuffle, 3 bit unshuffle.
int64_t zc_shuffle(const uint8_t* src, uint8_t* dst, int64_t n, int typesize, int mode) {
  if (typesize < 1 || n < 0 || mode < 0 || mode > 3) return E_ARG;
  size_t ts = size_t(typesize), len = size_t(n);
  if (mode == 0) shuffle_bytes(src, dst, len, ts);
  if (mode == 1) unshuffle_bytes(src, dst, len, ts);
  if (mode == 2) bitshuffle(src, dst, len, ts);
  if (mode == 3) bitunshuffle(src, dst, len, ts);
  return n;
}

}  // extern "C"
