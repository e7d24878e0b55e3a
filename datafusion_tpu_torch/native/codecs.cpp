// Page decompressors for the Parquet reader (native/parquet.cpp):
// GZIP (inflate, RFC 1951, in the gzip wrapper of RFC 1952 or the zlib
// wrapper of RFC 1950), ZSTD (the frame format of RFC 8878), LZ4_RAW
// (the LZ4 block format), LZ4 (the Hadoop framing of LZ4 blocks) and
// BROTLI (RFC 7932, its static dictionary and transforms compiled in
// from brotli_dictionary.cpp).  C++17 and the standard library only: no
// system libz, libzstd, liblz4 or libbrotli is linked.
//
// One entry, dtf_codec::decompress, fills exactly `cap` bytes of the
// caller's buffer or throws std::runtime_error; every read of the input
// and every write and back-reference of the output is checked against
// its buffer.  The decoders keep no state between calls, so each
// column thread decodes its pages on its own.

#include <array>
#include <cstdint>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace dtf_codec {

// RFC 7932's tables, in brotli_dictionary.cpp (generated by
// scripts/port_brotli_dictionary.py)
struct BrotliTransform {
  uint8_t prefix_len;
  const char* prefix;
  uint8_t type;  // 0 identity, 1-9 omit last k, 10 uppercase first,
                 // 11 uppercase all, 12-20 omit first (type - 11)
  uint8_t suffix_len;
  const char* suffix;
};
extern const char kBrotliDictionary[122785];
extern const BrotliTransform kBrotliTransforms[121];
extern const uint8_t kBrotliContextLut[2048];

namespace {

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError(msg); }

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// up to 8 bytes from [p, end), zero-filled past end
inline uint64_t load_upto8(const uint8_t* p, const uint8_t* end) {
  if (end - p >= 8) return load64(p);
  uint64_t v = 0;
  for (int i = 0; p + i < end; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// Copies a back-reference of `len` bytes from `dist` bytes back to
// out[op..); the caller has checked dist <= op and op + len <= cap.
inline void copy_match(uint8_t* out, size_t op, size_t dist, size_t len, size_t cap) {
  uint8_t* d = out + op;
  const uint8_t* s = d - dist;
  if (dist >= 8 && cap - op >= len + 8) {
    // 8 bytes at a time; each source block is written before it is read
    for (size_t i = 0; i < len; i += 8) std::memcpy(d + i, s + i, 8);
  } else if (dist >= len) {
    std::memcpy(d, s, len);
  } else if (dist == 1) {
    std::memset(d, *s, len);
  } else {
    for (size_t i = 0; i < len; ++i) d[i] = s[i];
  }
}

// ------------------------------------------------------------ checksums

struct Crc32Table {
  uint32_t t[8][256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xff];
  }
};

uint32_t crc32(const uint8_t* p, size_t n) {
  static const Crc32Table tab;  // built once, thread-safe
  const auto& t = tab.t;
  uint32_t c = 0xffffffffu;
  while (n >= 8) {  // slicing by 8
    uint32_t a = load32(p) ^ c, b = load32(p + 4);
    c = t[7][a & 0xff] ^ t[6][(a >> 8) & 0xff] ^ t[5][(a >> 16) & 0xff] ^ t[4][a >> 24] ^
        t[3][b & 0xff] ^ t[2][(b >> 8) & 0xff] ^ t[1][(b >> 16) & 0xff] ^ t[0][b >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = t[0][(c ^ *p++) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;  // the most bytes before b can overflow
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                 P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                 P5 = 2870177450012600261ull;
  auto round = [&](uint64_t acc, uint64_t in) {
    acc += in * P2;
    acc = rotl64(acc, 31);
    return acc * P1;
  };
  auto merge = [&](uint64_t acc, uint64_t v) {
    acc ^= round(0, v);
    return acc * P1 + P4;
  };
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = uint64_t(0) - P1;
    do {
      v1 = round(v1, load64(p));
      v2 = round(v2, load64(p + 8));
      v3 = round(v3, load64(p + 16));
      v4 = round(v4, load64(p + 24));
      p += 32;
    } while (end - p >= 32);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h ^= round(0, load64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= uint64_t(load32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ inflate

// Deflate reads bits least significant first.
struct LsbBits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;

  void refill() {
    if (end - p >= 8) {
      buf |= load64(p) << cnt;
      p += (63 - cnt) >> 3;
      cnt |= 56;
    } else {
      while (cnt <= 56 && p < end) {
        buf |= uint64_t(*p++) << cnt;
        cnt += 8;
      }
    }
  }
  uint32_t bits(int n) {  // n <= 32
    if (cnt < n) {
      refill();
      if (cnt < n) fail("truncated deflate stream");
    }
    uint32_t v = uint32_t(buf & ((uint64_t(1) << n) - 1));
    buf >>= n;
    cnt -= n;
    return v;
  }
  void align() {  // to the next byte
    buf >>= cnt & 7;
    cnt -= cnt & 7;
  }
  const uint8_t* position() const { return p - cnt / 8; }  // after align()
};

// A canonical Huffman code: a lookup of the first FAST bits for codes
// that short, the counts and symbols of puff.c's decoder for the rest.
struct Huffman {
  static constexpr int FAST = 10;
  uint16_t fast[1 << FAST];  // symbol << 4 | length, 0 for a longer code
  uint16_t count[16];
  uint16_t symbol[320];

  // returns the codes left unused: 0 complete, > 0 incomplete; throws
  // when over-subscribed
  int build(const uint8_t* lengths, int n) {
    std::memset(count, 0, sizeof count);
    for (int s = 0; s < n; ++s) count[lengths[s]]++;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) fail("over-subscribed Huffman code in deflate stream");
    }
    uint16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbol[offs[lengths[s]]++] = uint16_t(s);
    std::memset(fast, 0, sizeof fast);
    int code = 0, k = 0;
    for (int len = 1; len <= FAST; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        int rev = 0;  // the code's bits in stream order
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < (1 << FAST); j += 1 << len)
          fast[j] = uint16_t(symbol[k] << 4 | len);
      }
      code <<= 1;
    }
    return left;
  }

  int decode(LsbBits& br) const {
    if (br.cnt < 15) br.refill();
    uint16_t e = fast[br.buf & ((1u << FAST) - 1)];
    int len = e & 15;
    if (len) {
      if (len > br.cnt) fail("truncated deflate stream");
      br.buf >>= len;
      br.cnt -= len;
      return e >> 4;
    }
    // a code longer than FAST bits: puff's canonical walk
    int code = 0, first = 0, index = 0;
    for (len = 1; len < 16; ++len) {
      code |= int(br.bits(1));
      int c = count[len];
      if (code - c < first) return symbol[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("bad Huffman code in deflate stream");
  }
};

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

struct FixedCodes {
  Huffman lit, dist;
  FixedCodes() {
    uint8_t l[288];
    int s = 0;
    for (; s < 144; ++s) l[s] = 8;
    for (; s < 256; ++s) l[s] = 9;
    for (; s < 280; ++s) l[s] = 7;
    for (; s < 288; ++s) l[s] = 8;
    lit.build(l, 288);
    uint8_t d[30];
    std::memset(d, 5, sizeof d);
    dist.build(d, 30);
  }
};

// One block's literals and matches into out[op..cap); `start` is where
// this deflate stream's output begins (no reference reaches before it).
void inflate_codes(LsbBits& br, const Huffman& lit, const Huffman& dist, uint8_t* out,
                   size_t start, size_t& op, size_t cap) {
  for (;;) {
    int sym = lit.decode(br);
    if (sym < 256) {
      if (op >= cap) fail("deflate output longer than the page header says");
      out[op++] = uint8_t(sym);
      continue;
    }
    if (sym == 256) return;
    sym -= 257;
    if (sym >= 29) fail("bad length code in deflate stream");
    size_t len = kLenBase[sym] + br.bits(kLenExtra[sym]);
    int ds = dist.decode(br);
    if (ds >= 30) fail("bad distance code in deflate stream");
    size_t d = kDistBase[ds] + br.bits(kDistExtra[ds]);
    if (d > op - start) fail("deflate distance reaches before the stream's output");
    if (cap - op < len) fail("deflate output longer than the page header says");
    copy_match(out, op, d, len, cap);
    op += len;
  }
}

// A raw deflate stream from br into out[op..cap); leaves br at the
// byte after the last block.
void inflate_stream(LsbBits& br, uint8_t* out, size_t& op, size_t cap) {
  static const FixedCodes fixed;
  const size_t start = op;
  std::unique_ptr<Huffman[]> dyn(new Huffman[2]);
  bool last = false;
  while (!last) {
    last = br.bits(1);
    uint32_t type = br.bits(2);
    if (type == 0) {  // stored
      br.align();
      uint32_t len = br.bits(16), nlen = br.bits(16);
      if ((len ^ 0xffff) != nlen) fail("bad stored block length in deflate stream");
      // whole bytes left in the bit buffer come first
      while (len && br.cnt >= 8) {
        if (op >= cap) fail("deflate output longer than the page header says");
        out[op++] = uint8_t(br.bits(8));
        --len;
      }
      if (len) {
        br.buf = 0;  // empty now: what it held past cnt is the bytes copied below
        if (size_t(br.end - br.p) < len) fail("truncated stored block in deflate stream");
        if (cap - op < len) fail("deflate output longer than the page header says");
        std::memcpy(out + op, br.p, len);
        br.p += len;
        op += len;
      }
    } else if (type == 1) {
      inflate_codes(br, fixed.lit, fixed.dist, out, start, op, cap);
    } else if (type == 2) {
      int nlen = int(br.bits(5)) + 257, ndist = int(br.bits(5)) + 1, ncode = int(br.bits(4)) + 4;
      if (nlen > 286 || ndist > 30) fail("bad code counts in deflate stream");
      static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                        11, 4, 12, 3, 13, 2, 14, 1, 15};
      uint8_t lengths[320] = {0};
      for (int i = 0; i < ncode; ++i) lengths[order[i]] = uint8_t(br.bits(3));
      Huffman& lencode = dyn[0];
      if (lencode.build(lengths, 19) != 0) fail("incomplete code-length code in deflate stream");
      int idx = 0;
      while (idx < nlen + ndist) {
        int sym = lencode.decode(br);
        if (sym < 16) {
          lengths[idx++] = uint8_t(sym);
          continue;
        }
        int len = 0, rep;
        if (sym == 16) {
          if (idx == 0) fail("repeat with no previous length in deflate stream");
          len = lengths[idx - 1];
          rep = 3 + int(br.bits(2));
        } else if (sym == 17) {
          rep = 3 + int(br.bits(3));
        } else {
          rep = 11 + int(br.bits(7));
        }
        if (idx + rep > nlen + ndist) fail("too many code lengths in deflate stream");
        while (rep--) lengths[idx++] = uint8_t(len);
      }
      if (lengths[256] == 0) fail("no end-of-block code in deflate stream");
      Huffman& litc = dyn[0];  // the code-length code is done with
      Huffman& distc = dyn[1];
      // an incomplete code is only allowed as one code of one bit (zlib's rule)
      if (litc.build(lengths, nlen) && nlen != litc.count[0] + litc.count[1])
        fail("incomplete literal/length code in deflate stream");
      if (distc.build(lengths + nlen, ndist) && ndist != distc.count[0] + distc.count[1])
        fail("incomplete distance code in deflate stream");
      inflate_codes(br, litc, distc, out, start, op, cap);
    } else {
      fail("bad block type in deflate stream");
    }
  }
  br.align();
}

void gunzip(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  const uint8_t* end = src + n;
  size_t op = 0;
  const bool gzip = n >= 2 && src[0] == 0x1f && src[1] == 0x8b;
  if (!gzip) {  // the zlib wrapper
    if (n < 2 || (src[0] & 0x0f) != 8 || (src[0] >> 4) > 7 ||
        ((unsigned(src[0]) << 8) | src[1]) % 31 != 0)
      fail("GZIP page holds neither a gzip nor a zlib stream");
    if (src[1] & 0x20) fail("zlib stream with a preset dictionary");
    LsbBits br{src + 2, end};
    inflate_stream(br, out, op, cap);
    const uint8_t* p = br.position();
    if (end - p < 4) fail("truncated zlib trailer");
    uint32_t want = uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
    if (adler32(out, op) != want) fail("zlib Adler-32 mismatch");
    if (p + 4 != end) fail("bytes after the zlib stream");
  } else {
    const uint8_t* p = src;
    while (p < end) {  // one or more members
      if (end - p < 10 || p[0] != 0x1f || p[1] != 0x8b) fail("bad gzip member header");
      if (p[2] != 8) fail("gzip member not deflate-compressed");
      uint8_t flg = p[3];
      if (flg & 0xe0) fail("reserved gzip flags set");
      p += 10;
      if (flg & 4) {  // FEXTRA
        if (end - p < 2) fail("truncated gzip header");
        size_t xlen = size_t(p[0]) | size_t(p[1]) << 8;
        p += 2;
        if (size_t(end - p) < xlen) fail("truncated gzip header");
        p += xlen;
      }
      for (int f : {8, 16}) {  // FNAME, FCOMMENT: zero-terminated
        if (!(flg & f)) continue;
        while (p < end && *p) ++p;
        if (p >= end) fail("truncated gzip header");
        ++p;
      }
      if (flg & 2) {  // FHCRC
        if (end - p < 2) fail("truncated gzip header");
        p += 2;
      }
      const size_t member = op;
      LsbBits br{p, end};
      inflate_stream(br, out, op, cap);
      p = br.position();
      if (end - p < 8) fail("truncated gzip trailer");
      if (crc32(out + member, op - member) != load32(p)) fail("gzip CRC-32 mismatch");
      if (uint32_t(op - member) != load32(p + 4)) fail("gzip ISIZE mismatch");
      p += 8;
    }
  }
  if (op != cap) fail("GZIP output shorter than the page header says");
}

// ------------------------------------------------------------ LZ4

// One LZ4 block into out[0..cap); returns the bytes written.
size_t lz4_block(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  const uint8_t* p = src;
  const uint8_t* end = src + n;
  size_t op = 0;
  if (n == 0) fail("empty LZ4 block");
  for (;;) {
    if (p >= end) fail("truncated LZ4 block");
    uint8_t token = *p++;
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (p >= end) fail("truncated LZ4 literal length");
        b = *p++;
        lit += b;
      } while (b == 255);
    }
    if (size_t(end - p) < lit) fail("truncated LZ4 literals");
    if (cap - op < lit) fail("LZ4 output longer than the page header says");
    std::memcpy(out + op, p, lit);
    p += lit;
    op += lit;
    if (p == end) return op;  // the last sequence holds literals only
    if (end - p < 2) fail("truncated LZ4 offset");
    size_t off = size_t(p[0]) | size_t(p[1]) << 8;
    p += 2;
    if (off == 0 || off > op) fail("bad LZ4 offset");
    size_t len = token & 15;
    if (len == 15) {
      uint8_t b;
      do {
        if (p >= end) fail("truncated LZ4 match length");
        b = *p++;
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (cap - op < len) fail("LZ4 output longer than the page header says");
    copy_match(out, op, off, len, cap);
    op += len;
  }
}

void lz4_raw(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  if (lz4_block(src, n, out, cap) != cap) fail("LZ4 output shorter than the page header says");
}

// Hadoop's framing: [decompressed u32 BE][compressed u32 BE][block]...;
// false when it does not cover the input exactly (parquet-cpp then
// reads the page as one raw block)
bool lz4_hadoop(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  size_t op = 0;
  auto be32 = [](const uint8_t* q) {
    return uint32_t(q[0]) << 24 | uint32_t(q[1]) << 16 | uint32_t(q[2]) << 8 | q[3];
  };
  while (n >= 8) {
    size_t dsize = be32(src), csize = be32(src + 4);
    src += 8;
    n -= 8;
    if (n < csize || cap - op < dsize) return false;
    try {
      if (lz4_block(src, csize, out + op, dsize) != dsize) return false;
    } catch (const CodecError&) {
      return false;
    }
    src += csize;
    n -= csize;
    op += dsize;
  }
  return n == 0 && op == cap;
}

// ------------------------------------------------------------ ZSTD

// A backward bit stream (FSE and Huffman streams of RFC 8878): bits
// [0, pos) remain, read from the top down; positions below 0 read as 0.
struct BackBits {
  const uint8_t* start;
  const uint8_t* end;
  int64_t pos;

  BackBits(const uint8_t* s, size_t n) : start(s), end(s + n) {
    if (n == 0 || s[n - 1] == 0) fail("ZSTD bit stream without its end mark");
    pos = int64_t(n) * 8 - (8 - highbit32(s[n - 1]));
  }
  // the n bits (n <= 56) below pos, without consuming them
  uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = pos - n;
    uint64_t v;
    if (lo >= 0) {
      v = load_upto8(start + (lo >> 3), end) >> (lo & 7);
    } else {  // the stream's first bits, below them zeros
      v = pos > 0 ? load_upto8(start, end) << (-lo) : 0;
    }
    return v & ((uint64_t(1) << n) - 1);
  }
  uint64_t read(int n) {
    uint64_t v = pos >= 0 ? peek(n) : 0;
    pos -= n;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// A forward little-endian bit reader over [p, end) (FSE table headers)
struct FwdBits {
  const uint8_t* p;
  const uint8_t* end;
  int64_t bit = 0;
  uint32_t peek(int n) const {  // n <= 24
    const uint8_t* q = p + (bit >> 3);
    uint64_t v = q < end ? load_upto8(q, end) : 0;
    return uint32_t((v >> (bit & 7)) & ((1u << n) - 1));
  }
  void skip(int n) { bit += n; }
};

struct FseEntry {
  uint16_t base;  // the next state, before adding the bits read
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  bool ready = false;
  std::array<FseEntry, 512> e;

  // from normalized counts (-1: "less than one")
  void build(const int16_t* norm, int nsym, int al) {
    const int size = 1 << al;
    int high = size - 1;
    uint16_t next[256];
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        e[high--].symbol = uint8_t(s);
        next[s] = 1;
      } else {
        next[s] = uint16_t(norm[s]);
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        e[pos].symbol = uint8_t(s);
        do pos = (pos + step) & mask;
        while (pos > high);
      }
    }
    if (pos != 0) fail("bad ZSTD FSE table");
    for (int u = 0; u < size; ++u) {
      int s = e[u].symbol;
      uint32_t x = next[s]++;
      int nb = al - highbit32(x);
      e[u].bits = uint8_t(nb);
      e[u].base = uint16_t((x << nb) - size);
    }
    log = al;
    ready = true;
  }
  void rle(uint8_t symbol) {
    e[0] = FseEntry{0, symbol, 0};
    log = 0;
    ready = true;
  }
  // an FSE table description from [p, end); returns the bytes read
  size_t read(const uint8_t* p, const uint8_t* end, int max_log, int max_sym) {
    if (p >= end) fail("truncated ZSTD FSE table");
    FwdBits br{p, end};
    int al = int(br.peek(4)) + 5;
    br.skip(4);
    if (al > max_log) fail("ZSTD FSE accuracy log too large");
    int16_t norm[256];
    int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1, sym = 0;
    bool prev0 = false;
    while (remaining > 1 && sym <= max_sym) {
      if (prev0) {
        int n0 = sym;
        for (;;) {
          uint32_t r = br.peek(2);
          br.skip(2);
          n0 += int(r);
          if (r != 3) break;
        }
        if (n0 > max_sym) fail("bad ZSTD FSE table");
        while (sym < n0) norm[sym++] = 0;
        if (sym > max_sym) break;
      }
      const int max = (2 * threshold - 1) - remaining;
      int count;
      uint32_t v = br.peek(nbits);
      if (int(v & (threshold - 1)) < max) {
        count = int(v & (threshold - 1));
        br.skip(nbits - 1);
      } else {
        count = int(v & (2 * threshold - 1));
        if (count >= threshold) count -= max;
        br.skip(nbits);
      }
      --count;
      remaining -= count < 0 ? -count : count;
      norm[sym++] = int16_t(count);
      prev0 = count == 0;
      while (remaining < threshold) {
        --nbits;
        threshold >>= 1;
      }
      if (br.bit > int64_t(end - p) * 8) fail("truncated ZSTD FSE table");
    }
    if (remaining != 1 || br.bit > int64_t(end - p) * 8) fail("bad ZSTD FSE table");
    build(norm, sym, al);
    return size_t((br.bit + 7) >> 3);
  }
};

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(BackBits& br, const FseTable& table) {
    t = &table;
    state = uint32_t(br.read(table.log));
  }
  uint8_t symbol() const { return t->e[state].symbol; }
  void update(BackBits& br) {
    const FseEntry& x = t->e[state];
    state = x.base + uint32_t(br.read(x.bits));
  }
};

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int max_bits = 0;
  bool ready = false;
  std::array<HufEntry, 1 << 11> e;
};

// A Huffman tree description; returns the bytes read
size_t read_huffman(const uint8_t* p, const uint8_t* end, HufTable& h) {
  if (p >= end) fail("truncated ZSTD Huffman tree");
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  const uint8_t head = *p;
  if (head < 128) {  // FSE-compressed weights
    size_t csize = head;
    if (size_t(end - p - 1) < csize || csize == 0) fail("truncated ZSTD Huffman tree");
    const uint8_t* q = p + 1;
    FseTable t;
    size_t hdr = t.read(q, q + csize, 6, 255);
    if (hdr >= csize) fail("bad ZSTD Huffman tree");
    BackBits br(q + hdr, csize - hdr);
    FseState s1, s2;
    s1.init(br, t);
    s2.init(br, t);
    for (;;) {
      if (nw > 253) fail("too many ZSTD Huffman weights");
      weights[nw++] = s1.symbol();
      s1.update(br);
      if (br.overflowed()) {
        weights[nw++] = s2.symbol();
        break;
      }
      if (nw > 253) fail("too many ZSTD Huffman weights");
      weights[nw++] = s2.symbol();
      s2.update(br);
      if (br.overflowed()) {
        weights[nw++] = s1.symbol();
        break;
      }
    }
    used = 1 + csize;
  } else {  // 4-bit weights
    nw = head - 127;
    size_t bytes = size_t(nw + 1) / 2;
    if (size_t(end - p - 1) < bytes) fail("truncated ZSTD Huffman tree");
    for (int i = 0; i < nw; ++i) weights[i] = (i & 1) ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4;
    used = 1 + bytes;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("bad ZSTD Huffman weight");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("bad ZSTD Huffman tree");
  const int max_bits = highbit32(total) + 1;
  if (max_bits > 11) fail("ZSTD Huffman code too long");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("bad ZSTD Huffman tree");
  if (nw >= 256) fail("too many ZSTD Huffman weights");
  weights[nw++] = uint8_t(highbit32(rest) + 1);
  // symbols by weight, then value; weight w fills 2^(w-1) entries
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      uint32_t span = 1u << (w - 1);
      HufEntry x{uint8_t(s), uint8_t(max_bits + 1 - w)};
      for (uint32_t k = 0; k < span; ++k) h.e[pos + k] = x;
      pos += span;
    }
  }
  h.max_bits = max_bits;
  h.ready = true;
  return used;
}

void huffman_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits br(p, n);
  const int mb = h.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  size_t i = 0;
  // 4 symbols (at most 44 bits) from each load of the 56 bits below pos;
  // pos >= 64 keeps the 8 bytes loaded inside the stream
  while (count - i >= 4 && br.pos >= 64) {
    const int64_t lo = br.pos - 56;
    const uint64_t w = load64(p + (lo >> 3)) >> (lo & 7);
    int avail = 56;
    for (int k = 0; k < 4; ++k) {
      const HufEntry& x = h.e[(w >> (avail - mb)) & mask];
      out[i++] = x.symbol;
      avail -= x.bits;
    }
    br.pos = lo + avail;
  }
  for (; i < count; ++i) {
    const HufEntry& x = h.e[br.peek(mb)];
    out[i] = x.symbol;
    br.pos -= x.bits;
    if (br.pos < 0) fail("truncated ZSTD Huffman stream");
  }
  if (br.pos != 0) fail("ZSTD Huffman stream not fully consumed");
}

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,   6,   7,   8,   9,    10,   11,   12,   13,    14,    15,   16,
                              17, 18, 19,  20,  21,  22,  23,   24,   25,   26,   27,    28,    29,   30,
                              31, 32, 33,  34,  35,  37,  39,   41,   43,   47,   51,    59,    67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t kMaxBlock = 128 * 1024;

struct ZstdFrame {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;  // a block's literals
};

// One sequence table by its mode; returns the bytes read
size_t read_seq_table(FseTable& t, int mode, const uint8_t* p, const uint8_t* end,
                      const int16_t* def, int def_n, int def_log, int max_log, int max_sym) {
  switch (mode) {
    case 0:
      t.build(def, def_n, def_log);
      return 0;
    case 1:
      if (p >= end) fail("truncated ZSTD sequences header");
      if (*p > max_sym) fail("bad ZSTD RLE symbol");
      t.rle(*p);
      return 1;
    case 2:
      return t.read(p, end, max_log, max_sym);
    default:
      if (!t.ready) fail("ZSTD repeat mode without a previous table");
      return 0;
  }
}

// A compressed block's content into out[op..cap)
void zstd_block(ZstdFrame& z, const uint8_t* p, size_t n, uint8_t* out, size_t frame_start,
                size_t& op, size_t cap) {
  const uint8_t* end = p + n;
  // literals section
  if (p >= end) fail("empty ZSTD block");
  const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen, csize = 0, hdr;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      regen = p[0] >> 3;
      hdr = 1;
    } else if (sf == 1) {
      if (end - p < 2) fail("truncated ZSTD literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      hdr = 2;
    } else {
      if (end - p < 3) fail("truncated ZSTD literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      hdr = 3;
    }
  } else {
    hdr = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (size_t(end - p) < hdr) fail("truncated ZSTD literals header");
    uint64_t v = 0;
    for (size_t i = 0; i < hdr; ++i) v |= uint64_t(p[i]) << (8 * i);
    v >>= 4;
    const int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    regen = size_t(v & ((1u << bits) - 1));
    csize = size_t((v >> bits) & ((1u << bits) - 1));
  }
  p += hdr;
  if (regen > kMaxBlock) fail("ZSTD literals larger than a block");
  z.lits.resize(regen + 8);
  uint8_t* lit = z.lits.data();
  if (ltype == 0) {
    if (size_t(end - p) < regen) fail("truncated ZSTD literals");
    std::memcpy(lit, p, regen);
    p += regen;
  } else if (ltype == 1) {
    if (p >= end) fail("truncated ZSTD literals");
    std::memset(lit, *p, regen);
    p += 1;
  } else {
    if (size_t(end - p) < csize) fail("truncated ZSTD literals");
    const uint8_t* q = p;
    const uint8_t* qend = p + csize;
    if (ltype == 2) {
      q += read_huffman(q, qend, z.huf);
    } else if (!z.huf.ready) {
      fail("ZSTD treeless literals without a previous Huffman table");
    }
    if (q > qend) fail("truncated ZSTD literals");
    if (sf == 0) {
      huffman_stream(z.huf, q, size_t(qend - q), lit, regen);
    } else {
      if (qend - q < 6) fail("truncated ZSTD jump table");
      size_t s1 = size_t(q[0]) | size_t(q[1]) << 8, s2 = size_t(q[2]) | size_t(q[3]) << 8,
             s3 = size_t(q[4]) | size_t(q[5]) << 8;
      q += 6;
      size_t avail = size_t(qend - q);
      if (s1 + s2 + s3 > avail) fail("bad ZSTD jump table");
      size_t s4 = avail - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("bad ZSTD literals size for 4 streams");
      huffman_stream(z.huf, q, s1, lit, seg);
      huffman_stream(z.huf, q + s1, s2, lit + seg, seg);
      huffman_stream(z.huf, q + s1 + s2, s3, lit + 2 * seg, seg);
      huffman_stream(z.huf, q + s1 + s2 + s3, s4, lit + 3 * seg, regen - 3 * seg);
    }
    p = qend;
  }

  // sequences section
  if (p >= end) fail("truncated ZSTD sequences header");
  size_t nseq = p[0];
  if (nseq < 128) {
    p += 1;
  } else if (nseq < 255) {
    if (end - p < 2) fail("truncated ZSTD sequences header");
    nseq = ((nseq - 128) << 8) + p[1];
    p += 2;
  } else {
    if (end - p < 3) fail("truncated ZSTD sequences header");
    nseq = size_t(p[1]) + (size_t(p[2]) << 8) + 0x7f00;
    p += 3;
  }
  const size_t block_start = op;
  size_t lp = 0;  // next literal
  if (nseq > 0) {
    if (p >= end) fail("truncated ZSTD sequences header");
    const uint8_t modes = *p++;
    if (modes & 3) fail("reserved ZSTD sequence mode bits set");
    p += read_seq_table(z.ll, modes >> 6, p, end, kLLDefault, 36, 6, 9, 35);
    p += read_seq_table(z.of, (modes >> 4) & 3, p, end, kOFDefault, 29, 5, 8, 31);
    p += read_seq_table(z.ml, (modes >> 2) & 3, p, end, kMLDefault, 53, 6, 9, 52);
    if (p > end) fail("truncated ZSTD sequences");
    BackBits br(p, size_t(end - p));
    FseState sll, sof, sml;
    sll.init(br, z.ll);
    sof.init(br, z.of);
    sml.init(br, z.ml);
    for (size_t i = 0; i < nseq; ++i) {
      const int llc = sll.symbol(), ofc = sof.symbol(), mlc = sml.symbol();
      if (llc > 35 || mlc > 52 || ofc > 31) fail("bad ZSTD sequence code");
      const uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
      const size_t ml = kMLBase[mlc] + size_t(br.read(kMLBits[mlc]));
      const size_t ll = kLLBase[llc] + size_t(br.read(kLLBits[llc]));
      if (br.overflowed()) fail("truncated ZSTD sequences");
      size_t off;
      if (ofv > 3) {
        off = size_t(ofv - 3);
        z.rep[2] = z.rep[1];
        z.rep[1] = z.rep[0];
        z.rep[0] = uint32_t(off);
      } else {
        const int idx = int(ofv) - 1 + (ll == 0);
        if (idx == 0) {
          off = z.rep[0];
        } else {
          off = idx == 3 ? size_t(z.rep[0]) - 1 : z.rep[idx];
          if (idx != 1) z.rep[2] = z.rep[1];
          z.rep[1] = z.rep[0];
          z.rep[0] = uint32_t(off);
        }
      }
      if (i + 1 < nseq) {  // the last sequence updates no state
        sll.update(br);
        sml.update(br);
        sof.update(br);
        if (br.overflowed()) fail("truncated ZSTD sequences");
      }
      // execute: literals, then the match
      if (regen - lp < ll) fail("ZSTD sequence past its literals");
      if (cap - op < ll) fail("ZSTD output longer than the page header says");
      std::memcpy(out + op, lit + lp, ll);
      lp += ll;
      op += ll;
      if (off == 0 || off > op - frame_start) fail("bad ZSTD match offset");
      if (cap - op < ml) fail("ZSTD output longer than the page header says");
      copy_match(out, op, off, ml, cap);
      op += ml;
    }
    if (br.pos != 0) fail("ZSTD sequence stream not fully consumed");
  } else if (p != end) {
    fail("bytes after a ZSTD block's literals");
  }
  const size_t rest = regen - lp;
  if (cap - op < rest) fail("ZSTD output longer than the page header says");
  std::memcpy(out + op, lit + lp, rest);
  op += rest;
  if (op - block_start > kMaxBlock) fail("ZSTD block larger than 128 KiB");
}

void zstd(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  const uint8_t* p = src;
  const uint8_t* end = src + n;
  size_t op = 0;
  if (n == 0) fail("empty ZSTD page");
  std::unique_ptr<ZstdFrame> z(new ZstdFrame);
  while (p < end) {  // concatenated frames
    if (end - p < 4) fail("truncated ZSTD frame");
    const uint32_t magic = load32(p);
    p += 4;
    if ((magic & 0xfffffff0u) == 0x184d2a50u) {  // a skippable frame
      if (end - p < 4) fail("truncated ZSTD skippable frame");
      uint32_t size = load32(p);
      p += 4;
      if (uint64_t(end - p) < size) fail("truncated ZSTD skippable frame");
      p += size;
      continue;
    }
    if (magic != 0xfd2fb528u) fail("bad ZSTD frame magic");
    if (p >= end) fail("truncated ZSTD frame header");
    const uint8_t fhd = *p++;
    const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
    const bool single = fhd & 0x20, checksum = fhd & 4;
    if (fhd & 8) fail("reserved ZSTD frame header bit set");
    const size_t dict_bytes = dict_flag == 0 ? 0 : dict_flag == 1 ? 1 : dict_flag == 2 ? 2 : 4;
    const size_t fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : size_t(1) << fcs_flag;
    const size_t need = (single ? 0 : 1) + dict_bytes + fcs_bytes;
    if (size_t(end - p) < need) fail("truncated ZSTD frame header");
    if (!single) ++p;  // the window descriptor: the page is the window
    uint32_t dict = 0;
    for (size_t i = 0; i < dict_bytes; ++i) dict |= uint32_t(p[i]) << (8 * i);
    p += dict_bytes;
    if (dict != 0) fail("ZSTD frame needs dictionary " + std::to_string(dict));
    uint64_t fcs = 0;
    for (size_t i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(p[i]) << (8 * i);
    if (fcs_bytes == 2) fcs += 256;
    p += fcs_bytes;
    const size_t frame_start = op;
    z->huf.ready = z->ll.ready = z->of.ready = z->ml.ready = false;
    z->rep[0] = 1;
    z->rep[1] = 4;
    z->rep[2] = 8;
    for (bool last = false; !last;) {
      if (end - p < 3) fail("truncated ZSTD block header");
      const uint32_t bh = uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
      p += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 0) {  // raw
        if (size_t(end - p) < size) fail("truncated ZSTD raw block");
        if (cap - op < size) fail("ZSTD output longer than the page header says");
        std::memcpy(out + op, p, size);
        p += size;
        op += size;
      } else if (type == 1) {  // RLE
        if (p >= end) fail("truncated ZSTD RLE block");
        if (cap - op < size) fail("ZSTD output longer than the page header says");
        std::memset(out + op, *p, size);
        p += 1;
        op += size;
      } else if (type == 2) {
        if (size > kMaxBlock) fail("ZSTD block larger than 128 KiB");
        if (size_t(end - p) < size) fail("truncated ZSTD compressed block");
        zstd_block(*z, p, size, out, frame_start, op, cap);
        p += size;
      } else {
        fail("reserved ZSTD block type");
      }
    }
    if (fcs_bytes && op - frame_start != fcs) fail("ZSTD frame content size mismatch");
    if (checksum) {
      if (end - p < 4) fail("truncated ZSTD checksum");
      if (uint32_t(xxh64(out + frame_start, op - frame_start)) != load32(p))
        fail("ZSTD content checksum mismatch");
      p += 4;
    }
  }
  if (op != cap) fail("ZSTD output shorter than the page header says");
}

// ------------------------------------------------------------ brotli

// RFC 7932.  Bits are read least significant first, as in deflate; the
// whole page is the window, so a back-reference reads the output itself.
struct BrotliBits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;

  void refill() {
    if (end - p >= 8) {
      buf |= load64(p) << cnt;
      p += (63 - cnt) >> 3;
      cnt |= 56;
    } else {
      while (cnt <= 56 && p < end) {
        buf |= uint64_t(*p++) << cnt;
        cnt += 8;
      }
    }
  }
  uint32_t bits(int n) {  // n <= 32
    if (n == 0) return 0;
    if (cnt < n) {
      refill();
      if (cnt < n) fail("truncated BROTLI stream");
    }
    uint32_t v = uint32_t(buf & ((uint64_t(1) << n) - 1));
    buf >>= n;
    cnt -= n;
    return v;
  }
  void skip(int n) {  // n <= cnt
    buf >>= n;
    cnt -= n;
  }
  void align() {  // to the next byte; the bits passed over must be 0
    const int k = cnt & 7;
    if (buf & ((uint64_t(1) << k) - 1)) fail("nonzero padding bits in BROTLI stream");
    skip(k);
  }
  // `n` whole bytes after align(), to `dst` (null: skipped)
  void take(uint8_t* dst, size_t n) {
    while (n && cnt >= 8) {
      const uint8_t b = uint8_t(bits(8));
      if (dst) *dst++ = b;
      --n;
    }
    if (!n) return;
    buf = 0;  // empty now: what it held past cnt is the bytes read below
    if (size_t(end - p) < n) fail("truncated BROTLI stream");
    if (dst) std::memcpy(dst, p, n);
    p += n;
  }
};

// A canonical prefix code of up to 704 symbols: a lookup of the first
// FAST bits for codes that short, puff's canonical walk for the rest.
// A code of one symbol reads no bits.
struct BrotliCode {
  static constexpr int FAST = 10;
  int single = -1;
  uint16_t fast[1 << FAST];  // symbol << 4 | length, 0 for a longer code
  uint16_t count[16];
  uint16_t symbol[704];

  // the code of `n` symbols with these lengths (at most 15), which must
  // fill the code space exactly
  void build(const uint8_t* lengths, int n) {
    single = -1;
    std::memset(count, 0, sizeof count);
    for (int s = 0; s < n; ++s) count[lengths[s]]++;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) fail("over-subscribed prefix code in BROTLI stream");
    }
    if (left != 0) fail("incomplete prefix code in BROTLI stream");
    uint16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbol[offs[lengths[s]]++] = uint16_t(s);
    std::memset(fast, 0, sizeof fast);
    int code = 0, k = 0;
    for (int len = 1; len <= FAST; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        int rev = 0;  // the code's bits in stream order
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < (1 << FAST); j += 1 << len)
          fast[j] = uint16_t(symbol[k] << 4 | len);
      }
      code <<= 1;
    }
  }

  int decode(BrotliBits& br) const {
    if (single >= 0) return single;
    if (br.cnt < 15) br.refill();
    const uint16_t e = fast[br.buf & ((1u << FAST) - 1)];
    int len = e & 15;
    if (len) {
      if (len > br.cnt) fail("truncated BROTLI stream");
      br.skip(len);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (len = 1; len < 16; ++len) {
      code |= int(br.bits(1));
      const int c = count[len];
      if (code - c < first) return symbol[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("bad prefix code in BROTLI stream");
  }
};

int bit_length(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

// A prefix code over an alphabet of `size` symbols (RFC 7932, 3.4-3.5).
void brotli_read_code(BrotliBits& br, int size, BrotliCode& out) {
  uint8_t lengths[704] = {0};
  const int hskip = int(br.bits(2));
  if (hskip == 1) {  // simple: 1 to 4 symbols
    const int nsym = int(br.bits(2)) + 1, width = bit_length(uint32_t(size - 1));
    int sym[4];
    for (int i = 0; i < nsym; ++i) {
      sym[i] = int(br.bits(width));
      if (sym[i] >= size) fail("BROTLI symbol past its alphabet");
      for (int j = 0; j < i; ++j)
        if (sym[j] == sym[i]) fail("repeated symbol in a BROTLI simple prefix code");
    }
    if (nsym == 1) {
      out.single = sym[0];
      return;
    }
    static const uint8_t kLengths[4][4] = {{0}, {1, 1}, {1, 2, 2}, {2, 2, 2, 2}};
    const uint8_t* lens = kLengths[nsym - 1];
    static const uint8_t kTree[4] = {1, 2, 3, 3};
    if (nsym == 4 && br.bits(1)) lens = kTree;
    for (int i = 0; i < nsym; ++i) lengths[sym[i]] = lens[i];
    out.build(lengths, size);
    return;
  }
  // complex: code lengths coded with a code of 18 symbols, whose own
  // lengths come in a fixed order, each in a fixed code of 2 to 4 bits
  static const uint8_t kOrder[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16,
                                     7, 8, 9, 10, 11, 12, 13, 14, 15};
  static const uint8_t kClLen[16] = {2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4};
  static const uint8_t kClVal[16] = {0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5};
  uint8_t cl[18] = {0};
  int space = 32, num = 0, last = 0;
  for (int i = hskip; i < 18; ++i) {
    if (br.cnt < 4) br.refill();
    const int idx = int(br.buf & 15);
    if (kClLen[idx] > br.cnt) fail("truncated BROTLI stream");
    br.skip(kClLen[idx]);
    const int v = kClVal[idx];
    cl[kOrder[i]] = uint8_t(v);
    if (v) {
      space -= 32 >> v;
      ++num;
      last = kOrder[i];
      if (space <= 0) break;
    }
  }
  if (num != 1 && space != 0) fail("bad code length code in BROTLI stream");
  BrotliCode clc;
  if (num == 1)
    clc.single = last;  // one code length symbol, read with no bits
  else
    clc.build(cl, 18);
  int sym = 0, prev = 8, repeat = 0, repeat_len = 0;
  space = 32768;
  while (sym < size && space > 0) {
    const int c = clc.decode(br);
    if (c < 16) {
      repeat = 0;
      lengths[sym++] = uint8_t(c);
      if (c) {
        prev = c;
        space -= 32768 >> c;
      }
      continue;
    }
    const int extra = c == 16 ? 2 : 3, len = c == 16 ? prev : 0;
    if (repeat_len != len) {
      repeat = 0;
      repeat_len = len;
    }
    const int old = repeat;
    if (repeat > 0) repeat = (repeat - 2) << extra;
    repeat += int(br.bits(extra)) + 3;
    const int delta = repeat - old;
    if (delta > size - sym) fail("BROTLI code lengths past the alphabet");
    std::memset(lengths + sym, len, size_t(delta));
    sym += delta;
    if (len) space -= delta << (15 - len);
  }
  if (space != 0) fail("incomplete prefix code in BROTLI stream");
  out.build(lengths, size);
}

int brotli_var_u8(BrotliBits& br) {  // VarLenUint8: 0 to 255
  if (!br.bits(1)) return 0;
  const int n = int(br.bits(3));
  return n ? (1 << n) + int(br.bits(n)) : 1;
}

const uint16_t kBlockLenBase[26] = {1,   5,   9,   13,  17,  25,   33,   41,   49,
                                    65,  81,  97,  113, 145, 177,  209,  241,  305,
                                    369, 497, 753, 1265, 2289, 4337, 8433, 16625};
const uint8_t kBlockLenExtra[26] = {2, 2, 2, 2, 3, 3, 3, 3, 4,  4,  4,  4,  5,
                                    5, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 24};
const uint32_t kInsBase[24] = {0,  1,  2,  3,  4,   5,   6,   8,   10,   14,   18,   26,
                               34, 50, 66, 98, 130, 194, 322, 578, 1090, 2114, 6210, 22594};
const uint8_t kInsExtra[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                               4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
const uint32_t kCopyBase[24] = {2,  3,  4,  5,  6,   7,   8,   9,   10,  12,   14,   18,
                                22, 30, 38, 54, 70, 102, 134, 198, 326, 582, 1094, 2118};
const uint8_t kCopyExtra[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2,
                                3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};
// per 64-command cell: insert and copy length code bases
const uint8_t kCellIns[11] = {0, 0, 0, 0, 8, 8, 0, 16, 8, 16, 16};
const uint8_t kCellCopy[11] = {0, 8, 0, 8, 0, 8, 16, 0, 16, 8, 16};
// log2 of the dictionary's words of each length, 4 to 24 (RFC 7932, 8)
const uint8_t kDictBits[25] = {0,  0,  0,  0,  10, 10, 11, 11, 10, 10, 10, 10, 10,
                               9,  9,  8,  7,  7,  8,  7,  7,  6,  6,  5,  5};

// One of the three block categories (literals, commands, distances):
// its block types' codes and the current type and count.
struct BrotliBlocks {
  int ntypes = 1, type = 0, rb[2] = {1, 0};  // rb: second-to-last and last type
  uint32_t left = 1u << 28;
  BrotliCode type_code, len_code;

  uint32_t length(BrotliBits& br) const {
    const int s = len_code.decode(br);
    return kBlockLenBase[s] + br.bits(kBlockLenExtra[s]);
  }
  void read(BrotliBits& br) {
    ntypes = brotli_var_u8(br) + 1;
    type = 0;
    rb[0] = 1;
    rb[1] = 0;
    left = 1u << 28;  // one type: never switches
    if (ntypes >= 2) {
      brotli_read_code(br, ntypes + 2, type_code);
      brotli_read_code(br, 26, len_code);
      left = length(br);
    }
  }
  void next(BrotliBits& br) {  // before each symbol of the category
    if (left == 0) {
      const int s = type_code.decode(br);
      int t = s == 0 ? rb[0] : s == 1 ? rb[1] + 1 : s - 2;
      if (t >= ntypes) t -= ntypes;
      rb[0] = rb[1];
      rb[1] = t;
      type = t;
      left = length(br);
    }
    --left;
  }
};

// A context map of `size` entries into `ntrees` trees (RFC 7932, 7.3).
void brotli_context_map(BrotliBits& br, int ntrees, std::vector<uint8_t>& map) {
  const int rlemax = br.bits(1) ? int(br.bits(4)) + 1 : 0;
  BrotliCode code;
  brotli_read_code(br, ntrees + rlemax, code);
  const size_t size = map.size();
  for (size_t i = 0; i < size;) {
    const int c = code.decode(br);
    if (c == 0) {
      map[i++] = 0;
    } else if (c <= rlemax) {
      const size_t reps = (size_t(1) << c) + br.bits(c);
      if (reps > size - i) fail("BROTLI context map run past its end");
      std::memset(map.data() + i, 0, reps);
      i += reps;
    } else {
      map[i++] = uint8_t(c - rlemax);
    }
  }
  if (br.bits(1)) {  // inverse move-to-front
    uint8_t mtf[256];
    for (int i = 0; i < 256; ++i) mtf[i] = uint8_t(i);
    for (size_t i = 0; i < size; ++i) {
      const uint8_t idx = map[i], v = mtf[idx];
      map[i] = v;
      std::memmove(mtf + 1, mtf, idx);
      mtf[0] = v;
    }
  }
}

// The UTF-8 uppercasing of RFC 7932's transforms: one character at p,
// returns its length (it may touch up to 2 bytes past the word).
int brotli_upper(uint8_t* p) {
  if (p[0] < 0xc0) {
    if (p[0] >= 'a' && p[0] <= 'z') p[0] ^= 32;
    return 1;
  }
  if (p[0] < 0xe0) {
    p[1] ^= 32;
    return 2;
  }
  p[2] ^= 5;
  return 3;
}

// Dictionary word `word` of `len` bytes under transform `t` into dst
// (room for 5 + 24 + 8 bytes and the uppercasing's 2 past the word);
// returns the bytes written.
int brotli_transform(uint8_t* dst, const uint8_t* word, int len, int t) {
  const BrotliTransform& tr = kBrotliTransforms[t];
  int k = tr.prefix_len;
  std::memcpy(dst, tr.prefix, size_t(k));
  if (tr.type <= 9) {
    len -= tr.type;
  } else if (tr.type >= 12) {
    const int skip = tr.type - 11;
    word += skip;
    len -= skip;
  }
  if (len < 0) len = 0;
  std::memcpy(dst + k, word, size_t(len));
  if (tr.type == 10 && len > 0) {
    brotli_upper(dst + k);
  } else if (tr.type == 11) {
    uint8_t* q = dst + k;
    for (int rest = len; rest > 0;) {
      const int step = brotli_upper(q);
      q += step;
      rest -= step;
    }
  }
  k += len;
  std::memcpy(dst + k, tr.suffix, tr.suffix_len);
  return k + tr.suffix_len;
}

// One compressed meta-block of `mlen` bytes into out[op..) (RFC 7932, 9.2-9.3)
void brotli_compressed(BrotliBits& br, size_t mlen, size_t window, uint8_t* out, size_t& op,
                       int dist_rb[4], int& dist_idx) {
  BrotliBlocks cat[3];  // literals, commands, distances
  for (auto& c : cat) c.read(br);
  const int npostfix = int(br.bits(2));
  const int ndirect = int(br.bits(4)) << npostfix;
  std::vector<uint8_t> mode(size_t(cat[0].ntypes));
  for (auto& m : mode) m = uint8_t(br.bits(2));
  const int ntrees_l = brotli_var_u8(br) + 1;
  std::vector<uint8_t> cmap_l(size_t(cat[0].ntypes) * 64, 0);
  if (ntrees_l >= 2) brotli_context_map(br, ntrees_l, cmap_l);
  const int ntrees_d = brotli_var_u8(br) + 1;
  std::vector<uint8_t> cmap_d(size_t(cat[2].ntypes) * 4, 0);
  if (ntrees_d >= 2) brotli_context_map(br, ntrees_d, cmap_d);
  const int dist_size = 16 + ndirect + (48 << npostfix);
  std::vector<BrotliCode> lit(static_cast<size_t>(ntrees_l));
  std::vector<BrotliCode> cmd(static_cast<size_t>(cat[1].ntypes));
  std::vector<BrotliCode> dist(static_cast<size_t>(ntrees_d));
  for (auto& c : lit) brotli_read_code(br, 256, c);
  for (auto& c : cmd) brotli_read_code(br, 704, c);
  for (auto& c : dist) brotli_read_code(br, dist_size, c);

  const uint32_t postfix_mask = (1u << npostfix) - 1;
  size_t left = mlen;
  while (left > 0) {
    cat[1].next(br);
    const int c = cmd[size_t(cat[1].type)].decode(br);
    const int cell = c >> 6;
    const int ic = kCellIns[cell] + ((c >> 3) & 7), cc = kCellCopy[cell] + (c & 7);
    const size_t ins = kInsBase[ic] + br.bits(kInsExtra[ic]);
    const int copy = int(kCopyBase[cc] + br.bits(kCopyExtra[cc]));
    if (ins > left) fail("BROTLI insert past its meta-block");
    for (size_t i = 0; i < ins; ++i) {
      cat[0].next(br);
      const uint8_t p1 = op ? out[op - 1] : 0, p2 = op > 1 ? out[op - 2] : 0;
      const uint8_t* lut = kBrotliContextLut + (mode[size_t(cat[0].type)] << 9);
      const int ctx = lut[p1] | lut[256 + p2];
      out[op++] = uint8_t(lit[cmap_l[size_t(cat[0].type) * 64 + size_t(ctx)]].decode(br));
    }
    left -= ins;
    if (left == 0) break;  // the command's copy is not taken

    int dcode = 0;
    if (cell >= 2) {  // a distance code; cells 0 and 1 mean code 0
      cat[2].next(br);
      const int ctx = copy > 4 ? 3 : copy - 2;
      dcode = dist[cmap_d[size_t(cat[2].type) * 4 + size_t(ctx)]].decode(br);
    }
    int64_t d;
    if (dcode < 16) {  // the last distances, or one of them moved by up to 3
      static const uint8_t kBack[16] = {1, 2, 3, 4, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2};
      static const int8_t kDelta[16] = {0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3};
      d = int64_t(dist_rb[(dist_idx - kBack[dcode]) & 3]) + kDelta[dcode];
      if (d <= 0) fail("BROTLI distance below 1");
    } else if (dcode < 16 + ndirect) {
      d = dcode - 15;
    } else {
      const int x = dcode - ndirect - 16;
      const int nbits = 1 + (x >> (npostfix + 1));
      const int64_t offset = (int64_t(2 + ((x >> npostfix) & 1)) << nbits) - 4;
      d = ((offset + br.bits(nbits)) << npostfix) + (x & int(postfix_mask)) + ndirect + 1;
    }
    const size_t max_distance = std::min(op, window);
    if (uint64_t(d) > max_distance) {  // a static dictionary word
      if (copy < 4 || copy > 24) fail("BROTLI dictionary word of a bad length");
      const int64_t id = d - int64_t(max_distance) - 1;
      const int nbits = kDictBits[copy];
      const int64_t t = id >> nbits;
      if (t >= 121) fail("BROTLI dictionary transform past the 121");
      size_t at = 0;
      for (int l = 4; l < copy; ++l) at += size_t(l) << kDictBits[l];
      at += size_t(id & ((int64_t(1) << nbits) - 1)) * size_t(copy);
      uint8_t word[48] = {0};
      const uint8_t* dict = reinterpret_cast<const uint8_t*>(kBrotliDictionary);
      const int n = brotli_transform(word, dict + at, copy, int(t));
      if (size_t(n) > left) fail("BROTLI dictionary word past its meta-block");
      std::memcpy(out + op, word, size_t(n));
      op += size_t(n);
      left -= size_t(n);
    } else {
      if (size_t(copy) > left) fail("BROTLI copy past its meta-block");
      copy_match(out, op, size_t(d), size_t(copy), op + left);
      op += size_t(copy);
      left -= size_t(copy);
      if (dcode != 0) {
        dist_rb[dist_idx & 3] = int(d);
        ++dist_idx;
      }
    }
  }
}

void brotli(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  BrotliBits br{src, src + n};
  int wbits = 16;  // the stream header: the window's size
  if (br.bits(1)) {
    const int a = int(br.bits(3));
    if (a) {
      wbits = 17 + a;
    } else {
      const int b = int(br.bits(3));
      if (b == 1) fail("BROTLI large-window stream");
      wbits = b ? 8 + b : 17;
    }
  }
  const size_t window = (size_t(1) << wbits) - 16;
  int dist_rb[4] = {16, 15, 11, 4}, dist_idx = 0;
  size_t op = 0;
  for (bool last = false; !last;) {
    last = br.bits(1);
    if (last && br.bits(1)) break;  // ISLASTEMPTY
    const int nibbles = int(br.bits(2)) + 4;
    if (nibbles == 7) {  // metadata, skipped
      if (br.bits(1)) fail("reserved bit set in BROTLI stream");
      const int nbytes = int(br.bits(2));
      size_t skip = 0;
      for (int i = 0; i < nbytes; ++i) {
        const uint32_t b = br.bits(8);
        if (i + 1 == nbytes && nbytes > 1 && b == 0) fail("bad BROTLI metadata length");
        skip |= size_t(b) << (8 * i);
      }
      if (nbytes) skip += 1;
      br.align();
      br.take(nullptr, skip);
      continue;
    }
    size_t mlen = 0;
    for (int i = 0; i < nibbles; ++i) {
      const uint32_t v = br.bits(4);
      if (i + 1 == nibbles && nibbles > 4 && v == 0) fail("bad BROTLI meta-block length");
      mlen |= size_t(v) << (4 * i);
    }
    mlen += 1;
    if (mlen > cap - op) fail("BROTLI output longer than the page header says");
    if (!last && br.bits(1)) {  // ISUNCOMPRESSED
      br.align();
      br.take(out + op, mlen);
      op += mlen;
      continue;
    }
    brotli_compressed(br, mlen, window, out, op, dist_rb, dist_idx);
  }
  br.align();  // bytes after the stream are left unread, as parquet-cpp leaves them
  if (op != cap) fail("BROTLI output shorter than the page header says");
}

}  // namespace

// Parquet codec ids (parquet.thrift CompressionCodec) this file decodes
bool supported(int codec) { return codec == 2 || (codec >= 4 && codec <= 7); }

// `n` bytes of page at `src` compressed with `codec` (GZIP 2, BROTLI 4,
// LZ4 5, ZSTD 6, LZ4_RAW 7) into exactly `cap` bytes at `dst`; throws
// std::runtime_error otherwise.
void decompress(int codec, const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  switch (codec) {
    case 2: gunzip(src, n, dst, cap); return;
    case 4: brotli(src, n, dst, cap); return;
    case 5:
      if (!lz4_hadoop(src, n, dst, cap)) lz4_raw(src, n, dst, cap);
      return;
    case 6: zstd(src, n, dst, cap); return;
    case 7: lz4_raw(src, n, dst, cap); return;
    default: fail("codec " + std::to_string(codec) + " has no decoder here");
  }
}

}  // namespace dtf_codec
