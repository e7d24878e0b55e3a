// Parquet reader for flat schemas, C++17 and the standard library only,
// behind a C ABI (`dtf_pq_*`) that native/parquet.py binds with ctypes.
//
// What it reads:
//   - the footer: `PAR1`, FileMetaData in the Thrift compact protocol
//     (unknown fields skipped by their wire type);
//   - a flat schema: top-level primitive fields, REQUIRED or OPTIONAL;
//     a group or a REPEATED field is reported as nested (the caller
//     raises), never read;
//   - per row group, each projected column chunk from
//     min(dictionary_page_offset, data_page_offset): DICTIONARY_PAGE,
//     DATA_PAGE (v1) and DATA_PAGE_V2 (levels never compressed);
//   - definition levels: the RLE/bit-packed hybrid (length-prefixed in
//     v1, sized by the header in v2) and the legacy BIT_PACKED encoding;
//   - values: PLAIN (BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE,
//     BYTE_ARRAY), PLAIN_DICTIONARY / RLE_DICTIONARY (a chunk may fall
//     back to PLAIN partway), RLE for BOOLEAN;
//   - codecs UNCOMPRESSED and SNAPPY (a raw-format decoder of its own).
// Anything else raises an error naming it and the column.  Every offset
// and length is checked against its buffer, so a truncated or corrupt
// file gives an error, never a read out of bounds.
//
// Output: a row group's projected columns decode whole into buffers
// the caller owns (one column chunk per thread); the caller cuts them
// into batches.  Per column: values in a fixed layout per physical type
// (BOOLEAN uint8, INT32 int32, INT64 int64, INT96 int64 nanoseconds
// since the epoch, FLOAT float32, DOUBLE float64, BYTE_ARRAY int32 codes
// into the chunk's local dictionary), NULLs as 0, and a validity byte a
// row for an OPTIONAL column.  A BYTE_ARRAY chunk's local dictionary is its dictionary page's
// values in page order, then the values of PLAIN pages in order of
// first appearance (a value already present keeps its code).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <stdexcept>
#include <string>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct PqError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw PqError(msg); }

// parquet.thrift enums
enum Physical { BOOLEAN = 0, INT32 = 1, INT64 = 2, INT96 = 3, FLOAT = 4, DOUBLE = 5,
                BYTE_ARRAY = 6, FIXED_LEN_BYTE_ARRAY = 7 };
enum Encoding { PLAIN = 0, PLAIN_DICTIONARY = 2, RLE = 3, BIT_PACKED = 4,
                RLE_DICTIONARY = 8 };
enum PageType { DATA_PAGE = 0, INDEX_PAGE = 1, DICTIONARY_PAGE = 2, DATA_PAGE_V2 = 3 };
enum Codec { UNCOMPRESSED = 0, SNAPPY = 1 };

const char* physical_name(int t) {
  static const char* names[] = {"BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
                                "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY"};
  return t >= 0 && t < 8 ? names[t] : "UNKNOWN";
}

std::string encoding_name(int e) {
  static const char* names[] = {"PLAIN", "GROUP_VAR_INT", "PLAIN_DICTIONARY", "RLE",
                                "BIT_PACKED", "DELTA_BINARY_PACKED",
                                "DELTA_LENGTH_BYTE_ARRAY", "DELTA_BYTE_ARRAY",
                                "RLE_DICTIONARY", "BYTE_STREAM_SPLIT"};
  if (e >= 0 && e < 10) return names[e];
  return "encoding " + std::to_string(e);
}

std::string codec_name(int c) {
  static const char* names[] = {"UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI",
                                "LZ4", "ZSTD", "LZ4_RAW"};
  if (c >= 0 && c < 8) return names[c];
  return "codec " + std::to_string(c);
}

int value_width(int physical) {
  switch (physical) {
    case BOOLEAN: return 1;
    case INT32: case FLOAT: case BYTE_ARRAY: return 4;
    default: return 8;  // INT64, DOUBLE, INT96 (as int64 nanoseconds)
  }
}

// ------------------------------------------------------------ Thrift

// Compact-protocol reader over [p, end).  Field ids follow the deltas
// of their struct; `skip` walks any value by its wire type, so fields
// this reader does not know (newer writers add some) pass unread.
struct Thrift {
  const uint8_t* p;
  const uint8_t* end;
  int depth = 0;

  enum { STOP = 0, TRUE_ = 1, FALSE_ = 2, BYTE = 3, I16 = 4, I32 = 5, I64 = 6,
         DOUBLE_ = 7, BINARY = 8, LIST = 9, SET = 10, MAP = 11, STRUCT = 12 };

  uint8_t byte() {
    if (p >= end) fail("truncated metadata");
    return *p++;
  }
  uint64_t varint() {
    uint64_t r = 0;
    for (int shift = 0; shift < 64; shift += 7) {
      uint8_t b = byte();
      r |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) return r;
    }
    fail("bad varint in metadata");
  }
  int64_t zigzag() {
    uint64_t v = varint();
    return int64_t(v >> 1) ^ -int64_t(v & 1);
  }
  int32_t i32() {
    int64_t v = zigzag();
    if (v < INT32_MIN || v > INT32_MAX) fail("metadata integer out of range");
    return int32_t(v);
  }
  std::string binary() {
    uint64_t n = varint();
    if (n > uint64_t(end - p)) fail("truncated metadata string");
    std::string s(reinterpret_cast<const char*>(p), size_t(n));
    p += n;
    return s;
  }
  // a field header: false at STOP
  bool field(int16_t& id, uint8_t& type) {
    uint8_t b = byte();
    if (b == STOP) return false;
    type = b & 0x0f;
    uint8_t delta = b >> 4;
    if (delta) {
      id = int16_t(id + delta);
    } else {
      int64_t v = zigzag();
      if (v < INT16_MIN || v > INT16_MAX) fail("bad field id in metadata");
      id = int16_t(v);
    }
    return true;
  }
  // a list or set header: (size, element type)
  std::pair<uint64_t, uint8_t> list() {
    uint8_t b = byte();
    uint64_t n = b >> 4;
    if (n == 15) n = varint();
    // every element takes a byte at least
    if (n > uint64_t(end - p)) fail("truncated metadata list");
    return {n, uint8_t(b & 0x0f)};
  }
  bool boolean(uint8_t type) {  // a field's bool rides in its type
    if (type == TRUE_) return true;
    if (type == FALSE_) return false;
    fail("metadata field is not a bool");
  }
  void skip(uint8_t type) {
    if (++depth > 64) fail("metadata nested too deep");
    switch (type) {
      case TRUE_: case FALSE_: break;
      case BYTE: byte(); break;
      case I16: case I32: case I64: varint(); break;
      case DOUBLE_:
        if (end - p < 8) fail("truncated metadata");
        p += 8;
        break;
      case BINARY: {
        uint64_t n = varint();
        if (n > uint64_t(end - p)) fail("truncated metadata string");
        p += n;
        break;
      }
      case LIST: case SET: {
        auto [n, et] = list();
        for (uint64_t i = 0; i < n; ++i) {
          if (et == TRUE_ || et == FALSE_) byte();  // a list's bools take a byte each
          else skip(et);
        }
        break;
      }
      case MAP: {
        uint64_t n = varint();
        if (n > uint64_t(end - p)) fail("truncated metadata map");
        if (n) {
          uint8_t kv = byte();
          for (uint64_t i = 0; i < n; ++i) {
            skip(kv >> 4);
            skip(kv & 0x0f);
          }
        }
        break;
      }
      case STRUCT: {
        int16_t id = 0;
        uint8_t t;
        while (field(id, t)) skip(t);
        break;
      }
      default: fail("bad wire type in metadata");
    }
    --depth;
  }
  // walk a struct, calling on(id, type) for each field; on() returns
  // false to have the field skipped
  template <class F>
  void fields(F on) {
    if (++depth > 64) fail("metadata nested too deep");
    int16_t id = 0;
    uint8_t t;
    while (field(id, t)) {
      if (!on(id, t)) skip(t);
    }
    --depth;
  }
};

// ------------------------------------------------------------ metadata

struct SchemaElement {
  int type = -1;  // Physical, -1 for a group
  int type_length = 0;
  int repetition = 0;  // 0 REQUIRED, 1 OPTIONAL, 2 REPEATED
  std::string name;
  int num_children = 0;
  int converted = -1;
  int scale = 0, precision = 0;
  // LogicalType: the union's field id (-1 none) and its two parameters:
  // TIME/TIMESTAMP (unit 1 ms, 2 us, 3 ns; isAdjustedToUTC), INTEGER
  // (bitWidth, isSigned), DECIMAL (scale, precision)
  int logical = -1, lt_a = 0, lt_b = 0;
};

void read_time_unit(Thrift& t, int& unit) {
  t.fields([&](int16_t id, uint8_t type) {
    if (type != Thrift::STRUCT || id < 1 || id > 3) return false;
    unit = id;
    t.skip(type);  // MilliSeconds / MicroSeconds / NanoSeconds: empty structs
    return true;
  });
}

void read_logical(Thrift& t, SchemaElement& el) {
  t.fields([&](int16_t id, uint8_t type) {
    if (type != Thrift::STRUCT) return false;
    el.logical = id;
    if (id == 7 || id == 8) {  // TIME, TIMESTAMP
      t.fields([&](int16_t f, uint8_t ft) {
        if (f == 1 && (ft == Thrift::TRUE_ || ft == Thrift::FALSE_)) {
          el.lt_b = t.boolean(ft);
          return true;
        }
        if (f == 2 && ft == Thrift::STRUCT) {
          read_time_unit(t, el.lt_a);
          return true;
        }
        return false;
      });
      return true;
    }
    if (id == 10) {  // INTEGER
      t.fields([&](int16_t f, uint8_t ft) {
        if (f == 1 && ft == Thrift::BYTE) {
          el.lt_a = int8_t(t.byte());
          return true;
        }
        if (f == 2 && (ft == Thrift::TRUE_ || ft == Thrift::FALSE_)) {
          el.lt_b = t.boolean(ft);
          return true;
        }
        return false;
      });
      return true;
    }
    if (id == 5) {  // DECIMAL
      t.fields([&](int16_t f, uint8_t ft) {
        if (ft != Thrift::I32 || (f != 1 && f != 2)) return false;
        (f == 1 ? el.lt_a : el.lt_b) = t.i32();
        return true;
      });
      return true;
    }
    return false;  // the other kinds carry no parameter
  });
}

SchemaElement read_schema_element(Thrift& t) {
  SchemaElement el;
  t.fields([&](int16_t id, uint8_t type) {
    switch (id) {
      case 1: if (type != Thrift::I32) return false; el.type = t.i32(); return true;
      case 2: if (type != Thrift::I32) return false; el.type_length = t.i32(); return true;
      case 3: if (type != Thrift::I32) return false; el.repetition = t.i32(); return true;
      case 4: if (type != Thrift::BINARY) return false; el.name = t.binary(); return true;
      case 5: if (type != Thrift::I32) return false; el.num_children = t.i32(); return true;
      case 6: if (type != Thrift::I32) return false; el.converted = t.i32(); return true;
      case 7: if (type != Thrift::I32) return false; el.scale = t.i32(); return true;
      case 8: if (type != Thrift::I32) return false; el.precision = t.i32(); return true;
      case 10:
        if (type != Thrift::STRUCT) return false;
        read_logical(t, el);
        return true;
      default: return false;
    }
  });
  return el;
}

struct ChunkMeta {
  int type = -1;
  int codec = -1;
  int64_t num_values = -1;
  int64_t data_page_offset = -1;
  int64_t dictionary_page_offset = -1;
  int64_t total_compressed_size = -1;
  bool external = false;  // file_path set: the chunk lives in another file
};

void read_column_meta(Thrift& t, ChunkMeta& c) {
  t.fields([&](int16_t id, uint8_t type) {
    switch (id) {
      case 1: if (type != Thrift::I32) return false; c.type = t.i32(); return true;
      case 4: if (type != Thrift::I32) return false; c.codec = t.i32(); return true;
      case 5: if (type != Thrift::I64) return false; c.num_values = t.zigzag(); return true;
      case 7:
        if (type != Thrift::I64) return false;
        c.total_compressed_size = t.zigzag();
        return true;
      case 9: if (type != Thrift::I64) return false; c.data_page_offset = t.zigzag(); return true;
      case 11:
        if (type != Thrift::I64) return false;
        c.dictionary_page_offset = t.zigzag();
        return true;
      default: return false;
    }
  });
}

ChunkMeta read_column_chunk(Thrift& t) {
  ChunkMeta c;
  bool has_meta = false;
  t.fields([&](int16_t id, uint8_t type) {
    if (id == 1 && type == Thrift::BINARY) {
      c.external = true;
      t.skip(type);
      return true;
    }
    if (id == 3 && type == Thrift::STRUCT) {
      read_column_meta(t, c);
      has_meta = true;
      return true;
    }
    return false;
  });
  if (!has_meta) fail("a column chunk has no metadata");
  return c;
}

struct RowGroupMeta {
  int64_t num_rows = -1;
  std::vector<ChunkMeta> columns;
};

RowGroupMeta read_row_group_meta(Thrift& t) {
  RowGroupMeta rg;
  t.fields([&](int16_t id, uint8_t type) {
    if (id == 1 && type == Thrift::LIST) {
      auto [n, et] = t.list();
      if (et != Thrift::STRUCT) fail("bad row group columns");
      for (uint64_t i = 0; i < n; ++i) rg.columns.push_back(read_column_chunk(t));
      return true;
    }
    if (id == 3 && type == Thrift::I64) {
      rg.num_rows = t.zigzag();
      return true;
    }
    return false;
  });
  if (rg.num_rows < 0) fail("a row group has no row count");
  return rg;
}

struct PageHeader {
  int type = -1;
  int32_t uncompressed = -1, compressed = -1;
  // DATA_PAGE, DATA_PAGE_V2, DICTIONARY_PAGE
  int32_t num_values = -1;
  int encoding = -1;
  int def_encoding = RLE;
  // DATA_PAGE_V2
  int32_t num_nulls = 0, def_bytes = 0, rep_bytes = 0;
  bool is_compressed = true;
};

PageHeader read_page_header(Thrift& t) {
  PageHeader h;
  t.fields([&](int16_t id, uint8_t type) {
    switch (id) {
      case 1: if (type != Thrift::I32) return false; h.type = t.i32(); return true;
      case 2: if (type != Thrift::I32) return false; h.uncompressed = t.i32(); return true;
      case 3: if (type != Thrift::I32) return false; h.compressed = t.i32(); return true;
      case 5:  // DataPageHeader
        if (type != Thrift::STRUCT) return false;
        t.fields([&](int16_t f, uint8_t ft) {
          if (ft != Thrift::I32) return false;
          if (f == 1) h.num_values = t.i32();
          else if (f == 2) h.encoding = t.i32();
          else if (f == 3) h.def_encoding = t.i32();
          else return false;
          return true;
        });
        return true;
      case 7:  // DictionaryPageHeader
        if (type != Thrift::STRUCT) return false;
        t.fields([&](int16_t f, uint8_t ft) {
          if (ft != Thrift::I32) return false;
          if (f == 1) h.num_values = t.i32();
          else if (f == 2) h.encoding = t.i32();
          else return false;
          return true;
        });
        return true;
      case 8:  // DataPageHeaderV2
        if (type != Thrift::STRUCT) return false;
        t.fields([&](int16_t f, uint8_t ft) {
          if (f == 7 && (ft == Thrift::TRUE_ || ft == Thrift::FALSE_)) {
            h.is_compressed = t.boolean(ft);
            return true;
          }
          if (ft != Thrift::I32) return false;
          if (f == 1) h.num_values = t.i32();
          else if (f == 2) h.num_nulls = t.i32();
          else if (f == 4) h.encoding = t.i32();
          else if (f == 5) h.def_bytes = t.i32();
          else if (f == 6) h.rep_bytes = t.i32();
          else return false;
          return true;
        });
        return true;
      default: return false;
    }
  });
  if (h.uncompressed < 0 || h.compressed < 0) fail("a page header has no sizes");
  return h;
}

// ------------------------------------------------------------ Snappy

uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Raw Snappy: a varint length, then literals and copies with 1-, 2- and
// 4-byte offsets.  The output must be exactly `out_len` bytes.
void snappy_decompress(const uint8_t* src, size_t n, uint8_t* out, size_t out_len) {
  const uint8_t* end = src + n;
  uint64_t len = 0;
  int shift = 0;
  for (;;) {
    if (src >= end || shift > 28) fail("bad Snappy length");
    uint8_t b = *src++;
    len |= uint64_t(b & 0x7f) << shift;
    shift += 7;
    if (!(b & 0x80)) break;
  }
  if (len != out_len) fail("Snappy length disagrees with the page header");
  size_t op = 0;
  while (src < end) {
    uint8_t tag = *src++;
    size_t length, offset;
    switch (tag & 3) {
      case 0: {  // literal
        length = (tag >> 2) + 1;
        if (length > 60) {
          size_t nb = length - 60;
          if (size_t(end - src) < nb) fail("truncated Snappy literal");
          length = 0;
          for (size_t i = 0; i < nb; ++i) length |= size_t(src[i]) << (8 * i);
          length += 1;
          src += nb;
        }
        if (size_t(end - src) < length || out_len - op < length) fail("bad Snappy literal");
        std::memcpy(out + op, src, length);
        src += length;
        op += length;
        continue;
      }
      case 1:
        if (src >= end) fail("truncated Snappy copy");
        length = ((tag >> 2) & 7) + 4;
        offset = (size_t(tag >> 5) << 8) | *src++;
        break;
      case 2:
        if (end - src < 2) fail("truncated Snappy copy");
        length = (tag >> 2) + 1;
        offset = size_t(src[0]) | (size_t(src[1]) << 8);
        src += 2;
        break;
      default:
        if (end - src < 4) fail("truncated Snappy copy");
        length = (tag >> 2) + 1;
        offset = le32(src);
        src += 4;
        break;
    }
    if (offset == 0 || offset > op || out_len - op < length) fail("bad Snappy copy");
    uint8_t* dst = out + op;
    const uint8_t* from = dst - offset;
    if (offset >= length) {
      std::memcpy(dst, from, length);
    } else {
      for (size_t i = 0; i < length; ++i) dst[i] = from[i];  // overlapping: byte by byte
    }
    op += length;
  }
  if (op != out_len) fail("Snappy output shorter than the page header says");
}

// ------------------------------------------------------------ levels, runs

uint64_t read_varint(const uint8_t*& p, const uint8_t* end) {
  uint64_t r = 0;
  for (int shift = 0; shift < 64; shift += 7) {
    if (p >= end) fail("truncated run header");
    uint8_t b = *p++;
    r |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) return r;
  }
  fail("bad run header");
}

// `n` values of `bw` bits from the RLE/bit-packed hybrid in [p, end)
// into out[0..n); returns the largest value seen.
template <class T>
uint32_t decode_hybrid(const uint8_t* p, const uint8_t* end, int bw, int64_t n, T* out) {
  if (bw < 0 || bw > 32) fail("bad bit width " + std::to_string(bw));
  const uint64_t mask = bw == 32 ? 0xffffffffull : ((1ull << bw) - 1);
  const int vbytes = (bw + 7) / 8;
  uint32_t top = 0;
  int64_t i = 0;
  while (i < n) {
    uint64_t header = read_varint(p, end);
    if (header & 1) {  // bit-packed: groups of 8 values
      uint64_t groups = header >> 1;
      if (groups > (uint64_t(1) << 40)) fail("bad bit-packed run");
      int64_t take = int64_t(std::min<uint64_t>(groups * 8, uint64_t(n - i)));
      size_t avail = size_t(end - p);
      size_t need = (size_t(take) * size_t(bw) + 7) / 8;
      if (need > avail) fail("truncated bit-packed run");
      // values whose 8-byte window lies inside the buffer load it whole
      const int64_t whole =
          avail >= 8 && bw > 0 ? std::min<int64_t>(take, int64_t((avail - 8) * 8 / bw) + 1) : 0;
      int64_t k = 0;
      if (bw == 0) {
        std::fill(out + i, out + i + take, T(0));
        k = take;
      }
      for (; k < whole; ++k) {
        uint64_t bit = uint64_t(k) * uint64_t(bw);
        uint64_t w;
        std::memcpy(&w, p + (bit >> 3), 8);
        uint32_t v = uint32_t((w >> (bit & 7)) & mask);
        top = std::max(top, v);
        out[i + k] = T(v);
      }
      for (; k < take; ++k) {  // the last few, byte by byte
        uint64_t bit = uint64_t(k) * uint64_t(bw);
        size_t at = size_t(bit >> 3);
        uint64_t w = 0;
        std::memcpy(&w, p + at, std::min<size_t>(8, avail - at));
        uint32_t v = uint32_t((w >> (bit & 7)) & mask);
        top = std::max(top, v);
        out[i + k] = T(v);
      }
      size_t run_bytes = size_t(groups) * size_t(bw);
      p += std::min(run_bytes, avail);
      i += take;
    } else {  // a run of one repeated value
      uint64_t count = header >> 1;
      if (end - p < vbytes) fail("truncated RLE run");
      uint32_t v = 0;
      for (int b = 0; b < vbytes; ++b) v |= uint32_t(p[b]) << (8 * b);
      p += vbytes;
      if (uint64_t(v) > mask) fail("RLE value wider than its bit width");
      int64_t take = int64_t(std::min<uint64_t>(count, uint64_t(n - i)));
      std::fill(out + i, out + i + take, T(v));
      if (take) top = std::max(top, v);
      i += take;
    }
  }
  return top;
}

// ------------------------------------------------------------ the file

// A buffer that keeps its memory across row groups: a column's chunk
// bytes, inflated pages and dictionary indices reuse it instead of
// faulting in new pages.
struct Buffer {
  std::unique_ptr<uint8_t[]> data;
  size_t cap = 0;
  uint8_t* reserve(size_t n) {
    if (n > cap) {
      data.reset();
      data.reset(new uint8_t[n ? n : 1]);
      cap = n;
    }
    return data.get();
  }
  uint8_t* get() const { return data.get(); }
};

struct Field {  // a top-level field
  SchemaElement el;
  bool nested = false;  // a group or REPEATED: never read
  int leaf = -1;        // its column chunk's index in each row group
};

struct Column {  // one projected column, and its decode of a row group
  int field = -1;
  int physical = -1;
  bool optional = false;
  std::string name;
  // the caller's output for the row group: rows * width value bytes, and
  // a validity byte a row (OPTIONAL columns)
  uint8_t* values = nullptr;
  uint8_t* valid = nullptr;
  Buffer chunk, page, index;  // the chunk's bytes, a page inflated, indices
  // BYTE_ARRAY: the local dictionary, and a map for PLAIN pages
  std::string blob;
  std::vector<int64_t> offsets{0};
  std::unordered_map<std::string, int32_t> memo;
  bool memo_built = false;
  // a numeric chunk's dictionary page, decoded
  std::vector<uint8_t> dict_values;
  int64_t dict_size = -1;
  std::string error;
};

struct File {
  std::string path;
  int fd = -1;
  int64_t size = 0;
  std::string error;
  std::vector<Field> fields;
  std::vector<RowGroupMeta> row_groups;
  int64_t num_rows = 0;
  int num_leaves = 0;
  // the scan
  std::vector<Column> cols;

  ~File() {
    if (fd >= 0) close(fd);
  }

  void read_at(int64_t off, int64_t n, uint8_t* out) const {
    if (off < 0 || n < 0 || off > size || n > size - off)
      fail("range [" + std::to_string(off) + ", +" + std::to_string(n) +
           ") lies outside the file (" + std::to_string(size) + " bytes)");
    int64_t done = 0;
    while (done < n) {
      ssize_t r = pread(fd, out + done, size_t(n - done), off + done);
      if (r < 0) {
        if (errno == EINTR) continue;
        fail(std::string("read failed: ") + std::strerror(errno));
      }
      if (r == 0) fail("unexpected end of file");
      done += r;
    }
  }

  void open_file() {
    fd = ::open(path.c_str(), O_RDONLY | O_CLOEXEC);
    if (fd < 0) fail(std::string("cannot open: ") + std::strerror(errno));
    struct stat st;
    if (fstat(fd, &st) != 0) fail(std::string("cannot stat: ") + std::strerror(errno));
    size = st.st_size;
    if (size < 12) fail("too short for a Parquet file");
    uint8_t head[4], tail[8];
    read_at(0, 4, head);
    read_at(size - 8, 8, tail);
    if (std::memcmp(head, "PAR1", 4) != 0) fail("no PAR1 magic at its start");
    if (std::memcmp(tail + 4, "PARE", 4) == 0) fail("encrypted footers are not supported");
    if (std::memcmp(tail + 4, "PAR1", 4) != 0) fail("no PAR1 magic at its end");
    uint32_t len = le32(tail);
    if (int64_t(len) > size - 12) fail("footer length " + std::to_string(len) +
                                       " exceeds the file");
    std::unique_ptr<uint8_t[]> footer(new uint8_t[len ? len : 1]);
    read_at(size - 8 - int64_t(len), len, footer.get());
    Thrift t{footer.get(), footer.get() + len};
    parse_metadata(t);
  }

  void parse_metadata(Thrift& t) {
    std::vector<SchemaElement> schema;
    bool has_rows = false;
    t.fields([&](int16_t id, uint8_t type) {
      if (id == 2 && type == Thrift::LIST) {
        auto [n, et] = t.list();
        if (et != Thrift::STRUCT) fail("bad schema list");
        for (uint64_t i = 0; i < n; ++i) schema.push_back(read_schema_element(t));
        return true;
      }
      if (id == 3 && type == Thrift::I64) {
        num_rows = t.zigzag();
        has_rows = true;
        return true;
      }
      if (id == 4 && type == Thrift::LIST) {
        auto [n, et] = t.list();
        if (et != Thrift::STRUCT) fail("bad row group list");
        for (uint64_t i = 0; i < n; ++i) row_groups.push_back(read_row_group_meta(t));
        return true;
      }
      return false;
    });
    if (schema.empty() || !has_rows) fail("metadata without a schema or a row count");
    build_fields(schema);
    int64_t total = 0;
    for (const auto& rg : row_groups) {
      if (int(rg.columns.size()) != num_leaves)
        fail("a row group holds " + std::to_string(rg.columns.size()) +
             " column chunks, the schema " + std::to_string(num_leaves) + " columns");
      if (rg.num_rows > INT32_MAX) fail("a row group of more than 2^31 - 1 rows");
      total += rg.num_rows;
    }
    if (total != num_rows)
      fail("row groups hold " + std::to_string(total) + " rows, the footer says " +
           std::to_string(num_rows));
  }

  // top-level fields from the depth-first schema list; a group's
  // descendants are leaves that take column chunk indices too
  void build_fields(const std::vector<SchemaElement>& schema) {
    const SchemaElement& root = schema[0];
    if (root.num_children < 0) fail("bad schema root");
    size_t i = 1;
    for (int c = 0; c < root.num_children; ++c) {
      if (i >= schema.size()) fail("schema list shorter than its tree");
      Field f;
      f.el = schema[i];
      f.nested = f.el.num_children > 0 || f.el.repetition == 2;
      if (f.el.num_children > 0) {
        // walk the group's subtree, counting its leaves
        int64_t pending = 1;
        while (pending > 0) {
          if (i >= schema.size()) fail("schema list shorter than its tree");
          const SchemaElement& e = schema[i++];
          --pending;
          if (e.num_children < 0 || e.num_children > 1 << 20) fail("bad schema group");
          if (e.num_children > 0) pending += e.num_children;
          else ++num_leaves;
        }
      } else {
        if (f.el.type < 0 || f.el.type > 7) fail("schema leaf '" + f.el.name + "' has no type");
        f.leaf = num_leaves++;
        ++i;
      }
      fields.push_back(std::move(f));
    }
    if (i != schema.size()) fail("schema list longer than its tree");
  }

  // ---------------------------------------------------------- the scan

  void select(const int32_t* idx, int n) {
    cols.clear();
    for (int j = 0; j < n; ++j) {
      if (idx[j] < 0 || idx[j] >= int(fields.size())) fail("bad field index");
      const Field& f = fields[idx[j]];
      if (f.nested) fail("column '" + f.el.name + "' is nested");
      Column c;
      c.field = idx[j];
      c.physical = f.el.type;
      c.optional = f.el.repetition == 1;
      c.name = f.el.name;
      if (c.physical == FIXED_LEN_BYTE_ARRAY)
        fail("column '" + c.name + "': FIXED_LEN_BYTE_ARRAY is not supported");
      for (const auto& rg : row_groups) {
        const ChunkMeta& m = rg.columns[f.leaf];
        if (m.external) fail("column '" + c.name + "': a chunk in another file");
        if (m.codec != UNCOMPRESSED && m.codec != SNAPPY)
          fail("column '" + c.name + "': compression codec " + codec_name(m.codec) +
               " is not supported (UNCOMPRESSED and SNAPPY are)");
        if (m.type != c.physical)
          fail("column '" + c.name + "': chunk type " + physical_name(m.type) +
               " disagrees with the schema's " + physical_name(c.physical));
      }
      cols.push_back(std::move(c));
    }
  }

  // Decodes row group `rg` of every selected column j into values[j]
  // (rows * width bytes) and valid[j] (rows bytes, OPTIONAL columns;
  // ignored for REQUIRED ones), one column chunk per thread.
  void read_row_group(int rg, uint8_t* const* values, uint8_t* const* valid) {
    if (rg < 0 || rg >= int(row_groups.size())) fail("bad row group index");
    const RowGroupMeta& meta = row_groups[rg];
    for (size_t j = 0; j < cols.size(); ++j) {
      cols[j].values = values[j];
      cols[j].valid = cols[j].optional ? valid[j] : nullptr;
      cols[j].error.clear();
      if (!cols[j].values || (cols[j].optional && !cols[j].valid)) fail("no output buffer");
    }
    auto work = [&](size_t j) {
      Column& c = cols[j];
      try {
        decode_chunk(c, meta.columns[fields[c.field].leaf], meta.num_rows);
      } catch (const PqError& e) {
        c.error = e.what();
      } catch (const std::bad_alloc&) {
        c.error = "out of memory";
      } catch (const std::exception& e) {  // nothing may leave a thread
        c.error = e.what();
      }
    };
    size_t threads =
        std::min<size_t>(cols.size(), std::max(1u, std::thread::hardware_concurrency()));
    if (threads <= 1 || meta.num_rows < 65536) {
      for (size_t j = 0; j < cols.size(); ++j) work(j);
    } else {
      std::vector<std::vector<size_t>> share(threads);
      for (size_t j = 0; j < cols.size(); ++j) share[j % threads].push_back(j);
      std::vector<std::thread> pool;
      try {
        for (size_t k = 0; k < threads; ++k)
          pool.emplace_back([&, k] { for (size_t j : share[k]) work(j); });
      } catch (const std::system_error& e) {
        for (auto& th : pool) th.join();
        fail(std::string("cannot start a decode thread: ") + e.what());
      }
      for (auto& th : pool) th.join();
    }
    for (const Column& c : cols)
      if (!c.error.empty()) fail("column '" + c.name + "', row group " + std::to_string(rg) +
                                 ": " + c.error);
  }

  // ---------------------------------------------------------- a chunk

  void decode_chunk(Column& c, const ChunkMeta& m, int64_t rows) const {
    int64_t start = m.data_page_offset;
    if (m.dictionary_page_offset > 0 && m.dictionary_page_offset < start)
      start = m.dictionary_page_offset;
    if (start < 4 || start >= size) fail("chunk offset outside the file");
    int64_t len = m.total_compressed_size;
    if (len <= 0) fail("bad chunk size");
    len = std::min(len, size - start);
    if (m.num_values != rows)
      fail("chunk holds " + std::to_string(m.num_values) + " values, its row group " +
           std::to_string(rows) + " rows");
    uint8_t* buf = c.chunk.reserve(size_t(len));
    read_at(start, len, buf);

    c.blob.clear();
    c.offsets.assign(1, 0);
    c.memo.clear();
    c.memo_built = false;
    c.dict_values.clear();
    c.dict_size = -1;

    const uint8_t* p = buf;
    const uint8_t* end = p + len;
    int64_t done = 0;
    while (done < rows) {
      if (p >= end) fail("chunk ends after " + std::to_string(done) + " of " +
                         std::to_string(rows) + " values");
      Thrift t{p, end};
      PageHeader h = read_page_header(t);
      p = t.p;
      if (h.compressed > end - p) fail("truncated page");
      const uint8_t* body = p;
      p += h.compressed;
      if (h.type == DICTIONARY_PAGE) {
        if (c.dict_size >= 0) fail("a second dictionary page");
        if (done > 0) fail("a dictionary page after data pages");
        if (h.num_values < 0) fail("bad dictionary page");
        if (h.encoding != PLAIN && h.encoding != PLAIN_DICTIONARY)
          fail("dictionary page encoding " + encoding_name(h.encoding) + " is not supported");
        const uint8_t* data = inflate(m.codec, body, h.compressed, h.uncompressed, c.page);
        read_dictionary(c, data, data + h.uncompressed, h.num_values);
      } else if (h.type == DATA_PAGE || h.type == DATA_PAGE_V2) {
        if (h.num_values < 0 || h.num_values > rows - done)
          fail("a page of " + std::to_string(h.num_values) + " values past the chunk's " +
               std::to_string(rows) + " rows");
        data_page(c, m.codec, h, body, done);
        done += h.num_values;
      }  // an index page, or a page type of later writers: skipped
    }
  }

  // a page's bytes, decompressed when the codec says so
  static const uint8_t* inflate(int codec, const uint8_t* body, int32_t compressed,
                                int32_t uncompressed, Buffer& out) {
    if (codec == UNCOMPRESSED) {
      if (compressed != uncompressed) fail("uncompressed page sizes disagree");
      return body;
    }
    // Snappy expands a copy of 2 bytes to 11 at most
    if (uint64_t(uncompressed) > uint64_t(compressed) * 22 + 64)
      fail("page's uncompressed size is past what Snappy can give");
    uint8_t* dst = out.reserve(size_t(uncompressed));
    snappy_decompress(body, size_t(compressed), dst, size_t(uncompressed));
    return dst;
  }

  static void add_string(Column& c, const uint8_t* s, uint32_t n) {
    c.blob.append(reinterpret_cast<const char*>(s), n);
    c.offsets.push_back(int64_t(c.blob.size()));
  }

  void read_dictionary(Column& c, const uint8_t* p, const uint8_t* end, int32_t n) const {
    if (c.physical == BYTE_ARRAY) {
      for (int32_t i = 0; i < n; ++i) {
        if (end - p < 4) fail("truncated dictionary page");
        uint32_t len = le32(p);
        p += 4;
        if (len > uint64_t(end - p)) fail("truncated dictionary page");
        add_string(c, p, len);
        p += len;
      }
    } else {
      const int64_t need = plain_bytes(c.physical, n);
      if (need > end - p) fail("truncated dictionary page");
      const int width = value_width(c.physical);
      c.dict_values.resize(size_t(n) * width);
      plain_fixed(c.physical, p, n, c.dict_values.data());
    }
    c.dict_size = n;
  }

  static int64_t plain_bytes(int physical, int64_t n) {
    switch (physical) {
      case BOOLEAN: return (n + 7) / 8;
      case INT32: case FLOAT: return n * 4;
      case INT96: return n * 12;
      default: return n * 8;
    }
  }

  // n PLAIN fixed-width values from p (bounds checked by the caller)
  static void plain_fixed(int physical, const uint8_t* p, int64_t n, uint8_t* out) {
    switch (physical) {
      case BOOLEAN:
        for (int64_t i = 0; i < n; ++i) out[i] = (p[i >> 3] >> (i & 7)) & 1;
        break;
      case INT96: {
        int64_t* o = reinterpret_cast<int64_t*>(out);
        for (int64_t i = 0; i < n; ++i) {
          uint64_t nanos;
          int32_t julian;
          std::memcpy(&nanos, p + 12 * i, 8);
          std::memcpy(&julian, p + 12 * i + 8, 4);
          // days since 1970-01-01, then nanoseconds (wrapping as int64)
          uint64_t days = uint64_t(int64_t(julian) - 2440588);
          o[i] = int64_t(days * 86400000000000ull + nanos);
        }
        break;
      }
      default:
        std::memcpy(out, p, size_t(n) * value_width(physical));
    }
  }

  void data_page(Column& c, int codec, const PageHeader& h, const uint8_t* body,
                 int64_t done) const {
    const int64_t n = h.num_values;
    uint8_t* valid = c.optional ? c.valid + done : nullptr;
    const uint8_t* data;
    const uint8_t* end;
    int64_t non_null = n;
    if (h.type == DATA_PAGE) {
      data = inflate(codec, body, h.compressed, h.uncompressed, c.page);
      end = data + h.uncompressed;
      if (valid) {
        if (h.def_encoding == RLE) {
          if (end - data < 4) fail("truncated definition levels");
          uint32_t len = le32(data);
          data += 4;
          if (len > uint64_t(end - data)) fail("truncated definition levels");
          if (decode_hybrid(data, data + len, 1, n, valid) > 1) fail("bad definition level");
          data += len;
        } else if (h.def_encoding == BIT_PACKED) {
          int64_t len = (n + 7) / 8;
          if (len > end - data) fail("truncated definition levels");
          for (int64_t i = 0; i < n; ++i) valid[i] = (data[i >> 3] >> (7 - (i & 7))) & 1;
          data += len;
        } else {
          fail("definition level encoding " + encoding_name(h.def_encoding) +
               " is not supported");
        }
      }
    } else {
      if (h.rep_bytes != 0) fail("repetition levels in a flat column");
      if (h.def_bytes < 0 || h.def_bytes > h.compressed) fail("bad definition levels size");
      if (valid) {
        if (decode_hybrid(body, body + h.def_bytes, 1, n, valid) > 1)
          fail("bad definition level");
      } else if (h.num_nulls != 0) {
        fail("NULLs in a REQUIRED column");
      }
      const uint8_t* values = body + h.def_bytes;
      const int32_t csize = h.compressed - h.def_bytes;
      const int32_t usize = h.uncompressed - h.def_bytes;
      if (usize < 0) fail("bad page sizes");
      if (h.is_compressed) {
        data = inflate(codec, values, csize, usize, c.page);
      } else {
        if (csize != usize) fail("uncompressed page sizes disagree");
        data = values;
      }
      end = data + usize;
    }
    if (valid) {
      non_null = 0;
      for (int64_t i = 0; i < n; ++i) non_null += valid[i];
    }

    const int width = value_width(c.physical);
    uint8_t* out = c.values + size_t(done) * width;
    decode_values(c, h.encoding, data, end, non_null, out);
    if (non_null < n) {  // spread the dense values out to their rows; NULLs read 0
      int64_t k = non_null;
      for (int64_t i = n - 1; i >= 0; --i) {
        if (valid[i]) {
          --k;
          if (k != i) std::memmove(out + i * width, out + k * width, width);
        } else {
          std::memset(out + i * width, 0, width);
        }
      }
    }
  }

  void decode_values(Column& c, int encoding, const uint8_t* p, const uint8_t* end,
                     int64_t n, uint8_t* out) const {
    if (encoding == PLAIN_DICTIONARY || encoding == RLE_DICTIONARY) {
      if (c.dict_size < 0) fail("dictionary-coded page without a dictionary page");
      if (n == 0) return;
      if (p >= end) fail("truncated dictionary indices");
      int bw = *p++;
      if (c.physical == BYTE_ARRAY) {
        int32_t* codes = reinterpret_cast<int32_t*>(out);
        uint32_t top = decode_hybrid(p, end, bw, n, codes);
        if (int64_t(top) >= c.dict_size) fail("dictionary index out of range");
        return;
      }
      uint32_t* idx = reinterpret_cast<uint32_t*>(c.index.reserve(size_t(n) * 4));
      uint32_t top = decode_hybrid(p, end, bw, n, idx);
      if (int64_t(top) >= c.dict_size) fail("dictionary index out of range");
      const int width = value_width(c.physical);
      const uint8_t* dict = c.dict_values.data();
      if (width == 8) {
        auto* o = reinterpret_cast<uint64_t*>(out);
        auto* d = reinterpret_cast<const uint64_t*>(dict);
        for (int64_t i = 0; i < n; ++i) o[i] = d[idx[i]];
      } else if (width == 4) {
        auto* o = reinterpret_cast<uint32_t*>(out);
        auto* d = reinterpret_cast<const uint32_t*>(dict);
        for (int64_t i = 0; i < n; ++i) o[i] = d[idx[i]];
      } else {
        for (int64_t i = 0; i < n; ++i) out[i] = dict[idx[i]];
      }
      return;
    }
    if (encoding == PLAIN) {
      if (c.physical == BYTE_ARRAY) {
        plain_strings(c, p, end, n, reinterpret_cast<int32_t*>(out));
        return;
      }
      if (plain_bytes(c.physical, n) > end - p) fail("truncated PLAIN values");
      plain_fixed(c.physical, p, n, out);
      return;
    }
    if (encoding == RLE && c.physical == BOOLEAN) {
      if (end - p < 4) fail("truncated RLE booleans");
      uint32_t len = le32(p);
      p += 4;
      if (len > uint64_t(end - p)) fail("truncated RLE booleans");
      decode_hybrid(p, p + len, 1, n, out);
      return;
    }
    fail("value encoding " + encoding_name(encoding) + " is not supported for " +
         physical_name(c.physical));
  }

  // PLAIN BYTE_ARRAY values as codes into the local dictionary, new
  // values appended in order of first appearance
  static void plain_strings(Column& c, const uint8_t* p, const uint8_t* end, int64_t n,
                            int32_t* codes) {
    if (!c.memo_built) {
      for (size_t k = 0; k + 1 < c.offsets.size(); ++k) {
        std::string s = c.blob.substr(size_t(c.offsets[k]),
                                      size_t(c.offsets[k + 1] - c.offsets[k]));
        c.memo.emplace(std::move(s), int32_t(k));
      }
      c.memo_built = true;
    }
    std::string key;
    for (int64_t i = 0; i < n; ++i) {
      if (end - p < 4) fail("truncated PLAIN strings");
      uint32_t len = le32(p);
      p += 4;
      if (len > uint64_t(end - p)) fail("truncated PLAIN strings");
      key.assign(reinterpret_cast<const char*>(p), len);
      auto it = c.memo.find(key);
      if (it == c.memo.end()) {
        int64_t code = int64_t(c.offsets.size()) - 1;
        if (code > INT32_MAX) fail("too many distinct strings");
        it = c.memo.emplace(key, int32_t(code)).first;
        add_string(c, p, len);
      }
      codes[i] = it->second;
      p += len;
    }
  }
};

File* as_file(void* h) { return static_cast<File*>(h); }

template <class F>
auto guarded(File* f, F body, decltype(body()) on_error) -> decltype(body()) {
  try {
    return body();
  } catch (const PqError& e) {
    f->error = e.what();
  } catch (const std::bad_alloc&) {
    f->error = "out of memory";
  } catch (const std::exception& e) {  // nothing may cross the C ABI
    f->error = e.what();
  }
  return on_error;
}

}  // namespace

extern "C" {

// Opens `path` and reads its footer; never returns null.  Check
// dtf_pq_error before anything else.
void* dtf_pq_open(const char* path) {
  File* f = new (std::nothrow) File;
  if (!f) return nullptr;
  guarded(f, [&] {
    f->path = path ? path : "";
    f->open_file();
    return 0;
  }, 0);
  return f;
}

const char* dtf_pq_error(void* h) {
  File* f = as_file(h);
  return f->error.empty() ? nullptr : f->error.c_str();
}

int32_t dtf_pq_num_row_groups(void* h) { return int32_t(as_file(h)->row_groups.size()); }
int32_t dtf_pq_num_fields(void* h) { return int32_t(as_file(h)->fields.size()); }

const char* dtf_pq_field_name(void* h, int32_t i, int32_t* len) {
  const std::string& s = as_file(h)->fields[i].el.name;
  *len = int32_t(s.size());
  return s.data();
}

// out[10]: nested, physical, repetition, converted type, logical kind,
// logical a, logical b, type_length, scale, precision
void dtf_pq_field_info(void* h, int32_t i, int32_t* out) {
  const Field& f = as_file(h)->fields[i];
  const SchemaElement& e = f.el;
  int32_t v[10] = {f.nested, e.type, e.repetition, e.converted, e.logical, e.lt_a, e.lt_b,
                   e.type_length, e.scale, e.precision};
  std::memcpy(out, v, sizeof v);
}

// Chooses the fields to read (indices into the fields); 0 on success,
// -1 with dtf_pq_error set (a nested field, an unsupported codec or
// type in any of their chunks).
int32_t dtf_pq_select(void* h, int32_t n, const int32_t* fields) {
  File* f = as_file(h);
  return guarded(f, [&] { f->select(fields, n); return 0; }, -1);
}

int64_t dtf_pq_row_group_rows(void* h, int32_t rg) {
  const File* f = as_file(h);
  return rg >= 0 && rg < int32_t(f->row_groups.size()) ? f->row_groups[rg].num_rows : -1;
}

// Decodes row group `rg` of the selected columns into the caller's
// buffers: values[j] of rows * width bytes (the layout above) and, for
// an OPTIONAL column, valid[j] of rows bytes.  0 on success, -1 with
// dtf_pq_error set.
int32_t dtf_pq_read_row_group(void* h, int32_t rg, uint8_t* const* values,
                              uint8_t* const* valid) {
  File* f = as_file(h);
  f->error.clear();
  return guarded(f, [&] { f->read_row_group(rg, values, valid); return 0; }, -1);
}

// Column j's local dictionary for the last row group read (BYTE_ARRAY):
// its size, and its strings as one blob with size + 1 offsets.
int32_t dtf_pq_dict_size(void* h, int32_t j) {
  return int32_t(as_file(h)->cols[j].offsets.size() - 1);
}

const char* dtf_pq_dict_blob(void* h, int32_t j) { return as_file(h)->cols[j].blob.data(); }

const int64_t* dtf_pq_dict_offsets(void* h, int32_t j) {
  return as_file(h)->cols[j].offsets.data();
}

void dtf_pq_close(void* h) { delete as_file(h); }

}  // extern "C"
