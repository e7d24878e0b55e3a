// CSV reader of the port: C++17 and the standard library only, behind a
// C ABI (`dtf_csv_*`) that native/csv.py binds with ctypes.
//
// What it reads is what the JAX package's default CSV reader reads
// (pyarrow's, `datafusion_tpu/io/readers.py` CsvReader, with its
// default ParseOptions and ConvertOptions(strings_can_be_null=True)):
//   - records end at LF, CRLF or a bare CR; a blank line is skipped; a
//     UTF-8 byte order mark at the start of the file is dropped;
//   - RFC 4180 quoting: a field that starts with `"` runs to the next
//     lone `"` and holds delimiters, newlines and `""` (one quote);
//     what follows a closing quote up to the delimiter is kept; a `"`
//     inside an unquoted field is a plain byte;
//   - every record has the header's field count (without a header, the
//     schema's); a header matches the schema's columns by name (the first
//     field of that name), else columns match by position;
//   - a field, quoted or not, that equals one of pyarrow's default null
//     spellings (kNullSpellings) is NULL in every column type;
//   - Utf8 fields are kept verbatim and must be valid UTF-8;
//   - Boolean fields are exactly 1 True TRUE true or 0 False FALSE false;
//   - Int and UInt fields, blanks (space, tab) trimmed: decimal digits,
//     a `-` only for a signed type, or `0x` and at most two hex digits a
//     byte of the type (the bits of the value); each width range-checked;
//   - Float fields, blanks trimmed: an optional sign, then digits with an
//     optional point and exponent, `inf`, `infinity`, `nan` or `nan(...)`
//     in any case; Float32 rounds once, from the text;
//   - unprojected columns are split off but never converted.
// Anything else is an error naming the column and the value.
//
// Structure: the file is read in blocks of `block_size` bytes by one
// thread that cuts each block after its last record end (a serial scan
// of quotes and newlines, so a block edge inside a quoted field or a
// CRLF never splits a record).  A pool of `threads` workers parses and
// converts whole blocks, each Utf8 column into codes of a dictionary
// local to the block (first appearance order).  The caller's thread
// takes blocks in file order: it merges each block's strings into the
// column's global dictionary as the rows that first hold them are
// taken, so codes follow first appearance across the file, and slices
// the rows into batches of exactly `batch_size` (the last one holds the
// rest).  At most threads + 2 blocks are read and not yet taken, and a
// file of fewer blocks than `threads` starts one worker a block.

#include <locale.h>
#include <sys/stat.h>

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <limits>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

namespace {

enum ColType : int32_t {
  T_BOOL = 0,
  T_INT8 = 1,
  T_INT16 = 2,
  T_INT32 = 3,
  T_INT64 = 4,
  T_UINT8 = 5,
  T_UINT16 = 6,
  T_UINT32 = 7,
  T_UINT64 = 8,
  T_FLOAT32 = 9,
  T_FLOAT64 = 10,
  T_UTF8 = 11,
};

const char* const kTypeNames[] = {"Boolean", "Int8",    "Int16",   "Int32",
                                  "Int64",   "UInt8",   "UInt16",  "UInt32",
                                  "UInt64",  "Float32", "Float64", "Utf8"};

size_t type_width(int32_t t) {
  switch (t) {
    case T_BOOL: case T_INT8: case T_UINT8: return 1;
    case T_INT16: case T_UINT16: return 2;
    case T_INT32: case T_UINT32: case T_FLOAT32: case T_UTF8: return 4;
    default: return 8;
  }
}

// pyarrow's ConvertOptions.null_values default
const char* const kNullSpellings[] = {
    "",     "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "N/A", "NA",     "NULL", "NaN",    "n/a",      "nan",  "null"};

bool is_null_spelling(std::string_view s) {
  if (s.size() > 8) return false;
  for (const char* n : kNullSpellings)
    if (s == n) return true;
  return false;
}

std::string_view trim_blanks(std::string_view s) {
  size_t a = 0, b = s.size();
  while (a < b && (s[a] == ' ' || s[a] == '\t')) a++;
  while (b > a && (s[b - 1] == ' ' || s[b - 1] == '\t')) b--;
  return s.substr(a, b - a);
}

bool valid_utf8(std::string_view s) {
  const auto* p = reinterpret_cast<const unsigned char*>(s.data());
  const auto* end = p + s.size();
  while (p < end) {
    if (end - p >= 8) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      if ((w & 0x8080808080808080ull) == 0) {
        p += 8;
        continue;
      }
    }
    unsigned c = *p;
    if (c < 0x80) {
      p++;
      continue;
    }
    int n;
    unsigned lo = 0x80, hi = 0xBF;  // the second byte's range
    if (c >= 0xC2 && c <= 0xDF) n = 1;
    else if (c == 0xE0) { n = 2; lo = 0xA0; }
    else if (c == 0xED) { n = 2; hi = 0x9F; }  // no surrogates
    else if (c >= 0xE1 && c <= 0xEF) n = 2;
    else if (c == 0xF0) { n = 3; lo = 0x90; }
    else if (c >= 0xF1 && c <= 0xF3) n = 3;
    else if (c == 0xF4) { n = 3; hi = 0x8F; }
    else return false;
    if (end - p <= n) return false;
    if (p[1] < lo || p[1] > hi) return false;
    for (int k = 2; k <= n; k++)
      if ((p[k] & 0xC0) != 0x80) return false;
    p += n + 1;
  }
  return true;
}

// -- numbers --

bool parse_hex(std::string_view s, size_t width, uint64_t* out) {
  // s holds the digits after "0x": 1 to 2 * width of them
  if (s.empty() || s.size() > 2 * width) return false;
  uint64_t v = 0;
  for (char ch : s) {
    unsigned d;
    if (ch >= '0' && ch <= '9') d = ch - '0';
    else if (ch >= 'a' && ch <= 'f') d = ch - 'a' + 10;
    else if (ch >= 'A' && ch <= 'F') d = ch - 'A' + 10;
    else return false;
    v = (v << 4) | d;
  }
  *out = v;
  return true;
}

bool is_hex_prefixed(std::string_view s) {
  return s.size() >= 3 && s[0] == '0' && (s[1] == 'x' || s[1] == 'X');
}

// Decimal digits only, into v <= limit.
bool parse_digits(std::string_view s, uint64_t limit, uint64_t* out) {
  if (s.empty()) return false;
  uint64_t v = 0;
  for (char ch : s) {
    if (ch < '0' || ch > '9') return false;
    unsigned d = ch - '0';
    if (v > (limit - d) / 10) return false;
    v = v * 10 + d;
  }
  *out = v;
  return true;
}

bool parse_signed(std::string_view s, size_t width, int64_t* out) {
  s = trim_blanks(s);
  if (is_hex_prefixed(s)) {
    uint64_t v;
    if (!parse_hex(s.substr(2), width, &v)) return false;
    switch (width) {  // the value's bits, as the type's
      case 1: *out = static_cast<int8_t>(static_cast<uint8_t>(v)); break;
      case 2: *out = static_cast<int16_t>(static_cast<uint16_t>(v)); break;
      case 4: *out = static_cast<int32_t>(static_cast<uint32_t>(v)); break;
      default: *out = static_cast<int64_t>(v); break;
    }
    return true;
  }
  bool neg = !s.empty() && s[0] == '-';
  uint64_t max = (width == 8) ? 0x7FFFFFFFFFFFFFFFull : ((1ull << (8 * width - 1)) - 1);
  uint64_t v;
  if (!parse_digits(neg ? s.substr(1) : s, neg ? max + 1 : max, &v)) return false;
  *out = neg ? static_cast<int64_t>(0 - v) : static_cast<int64_t>(v);
  return true;
}

bool parse_unsigned(std::string_view s, size_t width, uint64_t* out) {
  s = trim_blanks(s);
  if (is_hex_prefixed(s)) return parse_hex(s.substr(2), width, out);
  uint64_t max = (width == 8) ? ~0ull : ((1ull << (8 * width)) - 1);
  return parse_digits(s, max, out);
}

bool ieq(std::string_view s, const char* lower) {
  size_t n = std::strlen(lower);
  if (s.size() != n) return false;
  for (size_t i = 0; i < n; i++)
    if ((s[i] | 0x20) != lower[i]) return false;
  return true;
}

locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", static_cast<locale_t>(0));
  return loc;
}

const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
const float kPow10f[] = {1e0f, 1e1f, 1e2f, 1e3f, 1e4f, 1e5f,
                         1e6f, 1e7f, 1e8f, 1e9f, 1e10f};

// A float field: the grammar is checked here; a value with at most 19
// significant digits whose mantissa and power of ten are exact in the
// type takes one correctly rounded multiply or divide (Clinger's fast
// path), any other goes to strtod_l / strtof_l in the C locale, which
// round correctly from the text.
template <typename F>
bool parse_float(std::string_view s, F* out) {
  s = trim_blanks(s);
  size_t i = 0, n = s.size();
  bool neg = false;
  if (i < n && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  if (i == n) return false;
  std::string_view rest = s.substr(i);
  char c0 = s[i] | 0x20;
  if (c0 == 'i') {
    if (!ieq(rest, "inf") && !ieq(rest, "infinity")) return false;
    *out = neg ? -std::numeric_limits<F>::infinity() : std::numeric_limits<F>::infinity();
    return true;
  }
  if (c0 == 'n') {
    if (rest.size() < 3 || !ieq(rest.substr(0, 3), "nan")) return false;
    if (rest.size() > 3) {
      if (rest[3] != '(' || rest.back() != ')') return false;
      for (size_t k = 4; k + 1 < rest.size(); k++) {
        char ch = rest[k];
        if (!((ch >= '0' && ch <= '9') || (ch >= 'a' && ch <= 'z') ||
              (ch >= 'A' && ch <= 'Z') || ch == '_'))
          return false;
      }
    }
    F nan = std::numeric_limits<F>::quiet_NaN();
    *out = neg ? -nan : nan;
    return true;
  }
  uint64_t m = 0;
  int ndig = 0;
  int64_t exp10 = 0;
  bool any = false;
  for (; i < n && s[i] >= '0' && s[i] <= '9'; i++) {
    any = true;
    if (m == 0 && s[i] == '0') continue;  // a leading zero
    if (ndig < 19) m = m * 10 + (s[i] - '0');
    else exp10++;
    ndig++;
  }
  if (i < n && s[i] == '.') {
    for (i++; i < n && s[i] >= '0' && s[i] <= '9'; i++) {
      any = true;
      if (m == 0 && s[i] == '0') {
        exp10--;
        continue;
      }
      if (ndig < 19) {
        m = m * 10 + (s[i] - '0');
        exp10--;
      }
      ndig++;
    }
  }
  if (!any) return false;
  if (i < n && (s[i] | 0x20) == 'e') {
    i++;
    bool eneg = false;
    if (i < n && (s[i] == '+' || s[i] == '-')) eneg = s[i++] == '-';
    if (i == n) return false;
    int64_t e = 0;
    for (; i < n && s[i] >= '0' && s[i] <= '9'; i++)
      if (e < 100000) e = e * 10 + (s[i] - '0');
    exp10 += eneg ? -e : e;
  }
  if (i != n) return false;
  if (ndig <= 19) {
    if (sizeof(F) == 8 && m <= (1ull << 53) && exp10 >= -22 && exp10 <= 22) {
      double d = static_cast<double>(m);
      d = exp10 < 0 ? d / kPow10[-exp10] : d * kPow10[exp10];
      *out = static_cast<F>(neg ? -d : d);
      return true;
    }
    if (sizeof(F) == 4 && m <= (1ull << 24) && exp10 >= -10 && exp10 <= 10) {
      float f = static_cast<float>(m);
      f = exp10 < 0 ? f / kPow10f[-exp10] : f * kPow10f[exp10];
      *out = static_cast<F>(neg ? -f : f);
      return true;
    }
  }
  char buf[128];
  std::string big;
  const char* z;
  if (s.size() < sizeof buf) {
    std::memcpy(buf, s.data(), s.size());
    buf[s.size()] = '\0';
    z = buf;
  } else {
    big.assign(s);
    z = big.c_str();
  }
  char* end = nullptr;
  if (sizeof(F) == 4) *out = static_cast<F>(strtof_l(z, &end, c_locale()));
  else *out = static_cast<F>(strtod_l(z, &end, c_locale()));
  return end == z + s.size();
}

// -- dictionaries: open addressing over (pointer, length) keys --

struct StringTable {
  struct Entry {
    const char* p;
    uint32_t n;
    uint64_t hash;
  };
  std::vector<Entry> entries;
  std::vector<int32_t> slots = std::vector<int32_t>(64, -1);

  static uint64_t hash_of(std::string_view s) { return std::hash<std::string_view>()(s); }

  // The code of s, or -1 with *slot_out where it would go.
  int32_t find(std::string_view s, uint64_t h, size_t* slot_out) const {
    size_t mask = slots.size() - 1;
    for (size_t i = h & mask;; i = (i + 1) & mask) {
      int32_t e = slots[i];
      if (e < 0) {
        *slot_out = i;
        return -1;
      }
      const Entry& en = entries[e];
      if (en.hash == h && en.n == s.size() && std::memcmp(en.p, s.data(), s.size()) == 0)
        return e;
    }
  }

  // Insert a string that `find` did not find; `p` must stay valid.
  int32_t insert(const char* p, uint32_t n, uint64_t h, size_t slot) {
    int32_t code = static_cast<int32_t>(entries.size());
    entries.push_back({p, n, h});
    slots[slot] = code;
    if (entries.size() * 2 > slots.size()) rehash(slots.size() * 2);
    return code;
  }

  void rehash(size_t size) {
    slots.assign(size, -1);
    size_t mask = size - 1;
    for (size_t e = 0; e < entries.size(); e++) {
      size_t i = entries[e].hash & mask;
      while (slots[i] >= 0) i = (i + 1) & mask;
      slots[i] = static_cast<int32_t>(e);
    }
  }
};

// The file-wide dictionary of one Utf8 column: its strings in one arena
// (exported to the caller with their offsets).
struct GlobalDict {
  StringTable table;  // keys point into `keys`, rebuilt when it moves
  std::string arena;
  std::vector<int64_t> offsets = {0};
  std::deque<std::string> keys;  // stable copies for the table

  int32_t add(std::string_view s) {
    uint64_t h = StringTable::hash_of(s);
    size_t slot;
    int32_t code = table.find(s, h, &slot);
    if (code >= 0) return code;
    keys.emplace_back(s);
    arena.append(s.data(), s.size());
    offsets.push_back(static_cast<int64_t>(arena.size()));
    return table.insert(keys.back().data(), static_cast<uint32_t>(s.size()), h, slot);
  }
};

// -- tokenizer --

struct FieldRef {
  const char* p;  // into the block, or an offset into the scratch buffer
  uint32_t n;
  bool scratch;
};

// Skip blank lines at p; then split one record into `fields`.  Returns 1
// for a record, 0 at the end of the buffer, -1 for a quoted field that
// is never closed.
int next_record(const char*& p, const char* end, std::vector<FieldRef>& fields,
                std::string& scratch) {
  while (p < end && (*p == '\n' || *p == '\r')) p++;
  if (p == end) return 0;
  fields.clear();
  scratch.clear();
  for (;;) {
    if (p < end && *p == '"') {
      const char* q = p + 1;
      const char* close = static_cast<const char*>(std::memchr(q, '"', end - q));
      if (close == nullptr) return -1;
      bool simple = close + 1 == end || close[1] == ',' || close[1] == '\n' || close[1] == '\r';
      if (simple) {
        fields.push_back({q, static_cast<uint32_t>(close - q), false});
        p = close + 1;
      } else {
        size_t start = scratch.size();
        for (;;) {
          scratch.append(q, close - q);
          if (close + 1 < end && close[1] == '"') {  // "" is one quote
            scratch.push_back('"');
            q = close + 2;
            close = static_cast<const char*>(std::memchr(q, '"', end - q));
            if (close == nullptr) return -1;
            continue;
          }
          p = close + 1;
          break;
        }
        // after the closing quote: plain bytes up to the delimiter
        const char* f = p;
        while (f < end && *f != ',' && *f != '\n' && *f != '\r') f++;
        scratch.append(p, f - p);
        p = f;
        fields.push_back({reinterpret_cast<const char*>(start),
                          static_cast<uint32_t>(scratch.size() - start), true});
      }
    } else {
      const char* f = p;
      while (f < end && *f != ',' && *f != '\n' && *f != '\r') f++;
      fields.push_back({p, static_cast<uint32_t>(f - p), false});
      p = f;
    }
    if (p == end) break;
    char c = *p++;
    if (c == ',') continue;
    if (c == '\r' && p < end && *p == '\n') p++;
    break;
  }
  for (auto& f : fields)
    if (f.scratch) f.p = scratch.data() + reinterpret_cast<uintptr_t>(f.p);
  return 1;
}

// The offset just past the last record end of b[0, n) that lies outside
// quotes (a CRLF kept whole when its LF is in the buffer), or 0 if none.
// b[0] starts a record.  Quote state changes only at `"`: one that
// starts a field (after a delimiter or a record end) opens a quoted
// field, closed by the next lone `"`.
size_t last_record_end(const char* b, size_t n) {
  const char* p = b;
  const char* end = b + n;
  const char* last = nullptr;
  while (p < end) {
    const char* q = static_cast<const char*>(std::memchr(p, '"', end - p));
    const char* stop = q ? q : end;
    const char* lf = static_cast<const char*>(memrchr(p, '\n', stop - p));
    const char* cr = static_cast<const char*>(memrchr(p, '\r', stop - p));
    const char* t = std::max(lf ? lf : p - 1, cr ? cr : p - 1);
    if (t >= p) last = t;
    if (q == nullptr) break;
    bool opens = q == b || q[-1] == ',' || q[-1] == '\n' || q[-1] == '\r';
    p = q + 1;
    if (!opens) continue;
    for (;;) {  // inside quotes
      const char* c = static_cast<const char*>(std::memchr(p, '"', end - p));
      if (c == nullptr || c + 1 == end) {  // open (or unknown) at the end
        p = end;
        break;
      }
      if (c[1] == '"') {
        p = c + 2;
        continue;
      }
      p = c + 1;
      break;
    }
  }
  if (last == nullptr) return 0;
  if (*last == '\r' && last + 1 < end && last[1] == '\n') last++;
  return last + 1 - b;
}

// -- blocks --

struct OutCol {
  int32_t type;
  std::string name;
  size_t width;
};

struct BlockCol {
  std::vector<uint8_t> data;   // rows * width; Utf8: int32 local codes
  std::vector<uint8_t> valid;  // a byte a row
  bool any_null = false;
  // Utf8: the block's strings in order of first appearance, and the
  // row where each first appears (increasing with the code)
  StringTable dict;
  std::vector<int64_t> first_row;
  std::deque<std::string> unquoted;  // strings rebuilt from quoted fields
};

struct Block {
  std::string bytes;
  int64_t rows = 0;
  std::vector<BlockCol> cols;
  std::string error;
  bool done = false;
};

std::string quote_value(std::string_view s) {
  std::string v(s.substr(0, 64));
  if (s.size() > 64) v += "...";
  return "'" + v + "'";
}

struct Reader {
  // the file and its columns
  FILE* file = nullptr;
  std::string path;
  std::vector<OutCol> out;            // per projected schema column
  std::vector<int32_t> schema_to_out; // schema index -> out slot or -1
  std::vector<int32_t> file_to_out;   // file field -> out slot or -1
  size_t nfile = 0;
  int64_t batch_size = 0;
  size_t block_size = 0;
  int threads = 1;
  std::string carry;  // bytes read past the header, before the thread starts

  // the pipeline
  std::mutex mu;
  std::condition_variable cv_work, cv_done, cv_space;
  std::deque<std::shared_ptr<Block>> inflight;  // read and not yet taken, in order
  std::deque<std::shared_ptr<Block>> work;      // read and not yet parsed
  bool eof = false;
  bool stop = false;
  std::string io_error;
  std::thread reader_thread;
  std::vector<std::thread> workers;
  bool started = false;

  // the caller's side
  std::shared_ptr<Block> cur;
  int64_t cur_row = 0;
  std::vector<size_t> next_local;             // per out slot: next local code to merge
  std::vector<std::vector<int32_t>> luts;     // per out slot: local -> global code
  std::vector<std::vector<uint8_t>> batch_data, batch_valid;
  std::vector<bool> batch_any_null;
  std::vector<GlobalDict> dicts;
  bool finished = false;
  std::string error;

  ~Reader() { shutdown(); }

  void shutdown() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv_work.notify_all();
    cv_space.notify_all();
    cv_done.notify_all();
    if (reader_thread.joinable()) reader_thread.join();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    if (file) {
      fclose(file);
      file = nullptr;
    }
  }

  // Read up to `want` more bytes onto buf; false at the end of the file.
  bool read_more(std::string& buf, size_t want) {
    size_t old = buf.size();
    buf.resize(old + want);
    size_t got = 0;
    while (got < want) {
      size_t k = fread(&buf[old + got], 1, want - got, file);
      if (k == 0) break;
      got += k;
    }
    buf.resize(old + got);
    if (got < want && ferror(file)) throw std::runtime_error("cannot read " + path);
    return got == want;
  }

  void push_block(std::string&& bytes) {
    auto blk = std::make_shared<Block>();
    blk->bytes = std::move(bytes);
    std::lock_guard<std::mutex> g(mu);
    inflight.push_back(blk);
    work.push_back(blk);
    cv_work.notify_one();
  }

  void read_loop() {
    try {
      std::string buf = std::move(carry);
      bool more = true;
      size_t want = block_size;
      while (more) {
        {
          std::unique_lock<std::mutex> lk(mu);
          cv_space.wait(lk, [&] {
            return stop || inflight.size() < static_cast<size_t>(threads) + 2;
          });
          if (stop) return;
        }
        more = read_more(buf, want > buf.size() ? want - buf.size() : 0);
        size_t cut = more ? last_record_end(buf.data(), buf.size()) : buf.size();
        if (cut == 0) {  // a record longer than the block: read on
          want = buf.size() * 2;
          continue;
        }
        want = block_size;
        std::string rest = buf.substr(cut);
        buf.resize(cut);
        push_block(std::move(buf));
        buf = std::move(rest);
      }
    } catch (const std::exception& e) {
      std::lock_guard<std::mutex> g(mu);
      io_error = e.what();
    }
    std::lock_guard<std::mutex> g(mu);
    eof = true;
    cv_done.notify_all();
    cv_work.notify_all();
  }

  void work_loop() {
    for (;;) {
      std::shared_ptr<Block> blk;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !work.empty() || eof; });
        if (stop || (work.empty() && eof)) return;
        blk = work.front();
        work.pop_front();
      }
      parse_block(*blk);
      {
        std::lock_guard<std::mutex> g(mu);
        blk->done = true;
      }
      cv_done.notify_all();
    }
  }

  void start() {
    started = true;
    reader_thread = std::thread([this] { read_loop(); });
    for (int i = 0; i < threads; i++) workers.emplace_back([this] { work_loop(); });
  }

  // -- parse one block (a worker) --

  std::string convert_error(size_t slot, std::string_view v) const {
    const OutCol& c = out[slot];
    const char* what = "bad value";
    switch (c.type) {
      case T_BOOL: what = "bad bool"; break;
      case T_INT8: case T_INT16: case T_INT32: case T_INT64: what = "bad int"; break;
      case T_UINT8: case T_UINT16: case T_UINT32: case T_UINT64: what = "bad uint"; break;
      case T_FLOAT32: case T_FLOAT64: what = "bad float"; break;
      case T_UTF8: what = "invalid UTF-8"; break;
    }
    std::string type = c.type >= T_BOOL && c.type <= T_UTF8 ? kTypeNames[c.type] : "?";
    return std::string(what) + ": " + quote_value(v) + " in column '" + c.name + "' (" + type +
           ")";
  }

  void parse_block(Block& blk) {
    blk.cols.resize(out.size());
    int64_t cap = 0;
    const char* p = blk.bytes.data();
    const char* end = p + blk.bytes.size();
    std::vector<FieldRef> fields;
    std::string scratch;
    int64_t row = 0;
    for (;;) {
      const char* rec = p;
      int r = next_record(p, end, fields, scratch);
      if (r == 0) break;
      if (r < 0) {
        blk.error = "unterminated quoted field at the end of the file";
        return;
      }
      if (fields.size() != nfile) {
        while (rec < end && (*rec == '\n' || *rec == '\r')) rec++;
        blk.error = "CSV parse error: expected " + std::to_string(nfile) + " fields, got " +
                    std::to_string(fields.size()) + ": " +
                    quote_value(std::string_view(rec, p - rec));
        return;
      }
      if (row == cap) {
        cap = cap ? cap * 2 : 1024;
        for (size_t s = 0; s < out.size(); s++) {
          blk.cols[s].data.resize(cap * out[s].width);
          blk.cols[s].valid.resize(cap);
        }
      }
      for (size_t f = 0; f < nfile; f++) {
        int32_t s = file_to_out[f];
        if (s < 0) continue;
        std::string_view v(fields[f].p, fields[f].n);
        if (!convert(blk, s, row, v, fields[f].scratch)) {
          blk.error = convert_error(s, v);
          return;
        }
      }
      row++;
    }
    blk.rows = row;
    for (size_t s = 0; s < out.size(); s++) {
      blk.cols[s].data.resize(row * out[s].width);
      blk.cols[s].valid.resize(row);
    }
  }

  bool convert(Block& blk, size_t s, int64_t row, std::string_view v, bool scratch) {
    BlockCol& col = blk.cols[s];
    uint8_t* dst = col.data.data() + row * out[s].width;
    if (is_null_spelling(v)) {
      std::memset(dst, 0, out[s].width);
      col.valid[row] = 0;
      col.any_null = true;
      if (out[s].type == T_UTF8) {
        int32_t none = -1;
        std::memcpy(dst, &none, 4);
      }
      return true;
    }
    col.valid[row] = 1;
    switch (out[s].type) {
      case T_BOOL: {
        uint8_t b;
        if (v == "1" || v == "True" || v == "TRUE" || v == "true") b = 1;
        else if (v == "0" || v == "False" || v == "FALSE" || v == "false") b = 0;
        else return false;
        *dst = b;
        return true;
      }
      case T_INT8: case T_INT16: case T_INT32: case T_INT64: {
        int64_t x;
        if (!parse_signed(v, out[s].width, &x)) return false;
        switch (out[s].width) {
          case 1: { int8_t y = static_cast<int8_t>(x); std::memcpy(dst, &y, 1); break; }
          case 2: { int16_t y = static_cast<int16_t>(x); std::memcpy(dst, &y, 2); break; }
          case 4: { int32_t y = static_cast<int32_t>(x); std::memcpy(dst, &y, 4); break; }
          default: std::memcpy(dst, &x, 8); break;
        }
        return true;
      }
      case T_UINT8: case T_UINT16: case T_UINT32: case T_UINT64: {
        uint64_t x;
        if (!parse_unsigned(v, out[s].width, &x)) return false;
        switch (out[s].width) {
          case 1: { uint8_t y = static_cast<uint8_t>(x); std::memcpy(dst, &y, 1); break; }
          case 2: { uint16_t y = static_cast<uint16_t>(x); std::memcpy(dst, &y, 2); break; }
          case 4: { uint32_t y = static_cast<uint32_t>(x); std::memcpy(dst, &y, 4); break; }
          default: std::memcpy(dst, &x, 8); break;
        }
        return true;
      }
      case T_FLOAT32: {
        float x;
        if (!parse_float(v, &x)) return false;
        std::memcpy(dst, &x, 4);
        return true;
      }
      case T_FLOAT64: {
        double x;
        if (!parse_float(v, &x)) return false;
        std::memcpy(dst, &x, 8);
        return true;
      }
      case T_UTF8: {
        if (!valid_utf8(v)) return false;
        uint64_t h = StringTable::hash_of(v);
        size_t slot;
        int32_t code = col.dict.find(v, h, &slot);
        if (code < 0) {
          const char* keep = v.data();
          if (scratch) {  // the scratch buffer is reused: keep a copy
            col.unquoted.emplace_back(v);
            keep = col.unquoted.back().data();
          }
          code = col.dict.insert(keep, static_cast<uint32_t>(v.size()), h, slot);
          col.first_row.push_back(row);
        }
        std::memcpy(dst, &code, 4);
        return true;
      }
    }
    return false;
  }

  // -- the caller's side --

  // Rows of the next batch into batch_data / batch_valid: 0 at the end,
  // -1 on an error.
  int64_t next() {
    if (!error.empty()) return -1;
    if (finished) return 0;
    if (!started) start();
    for (size_t s = 0; s < out.size(); s++) batch_any_null[s] = false;
    int64_t rows = 0;
    while (rows < batch_size) {
      if (!cur) {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [&] {
          return (!inflight.empty() && inflight.front()->done) || (inflight.empty() && eof);
        });
        if (inflight.empty()) {
          if (!io_error.empty()) {
            error = io_error;
            return -1;
          }
          finished = true;
          break;
        }
        cur = inflight.front();
        lk.unlock();
        if (!cur->error.empty()) {
          error = cur->error;
          return -1;
        }
        cur_row = 0;
        for (size_t s = 0; s < out.size(); s++) {
          next_local[s] = 0;
          luts[s].clear();
        }
      }
      int64_t k = std::min(batch_size - rows, cur->rows - cur_row);
      for (size_t s = 0; s < out.size(); s++) take(s, rows, k);
      rows += k;
      cur_row += k;
      if (cur_row == cur->rows) {
        cur.reset();
        {
          std::lock_guard<std::mutex> g(mu);
          inflight.pop_front();
        }
        cv_space.notify_one();
      }
    }
    return rows;
  }

  void take(size_t s, int64_t at, int64_t k) {
    BlockCol& col = cur->cols[s];
    size_t w = out[s].width;
    std::memcpy(batch_valid[s].data() + at, col.valid.data() + cur_row, k);
    if (col.any_null && !batch_any_null[s])
      for (int64_t j = 0; j < k && !batch_any_null[s]; j++)
        batch_any_null[s] = col.valid[cur_row + j] == 0;
    if (out[s].type != T_UTF8) {
      std::memcpy(batch_data[s].data() + at * w, col.data.data() + cur_row * w, k * w);
      return;
    }
    // the block's strings first held by these rows join the global
    // dictionary in their order of first appearance
    auto& lut = luts[s];
    auto& entries = col.dict.entries;
    size_t& nl = next_local[s];
    while (nl < entries.size() && col.first_row[nl] < cur_row + k) {
      lut.push_back(dicts[s].add(std::string_view(entries[nl].p, entries[nl].n)));
      nl++;
    }
    const int32_t* src = reinterpret_cast<const int32_t*>(col.data.data()) + cur_row;
    int32_t* dst = reinterpret_cast<int32_t*>(batch_data[s].data()) + at;
    for (int64_t j = 0; j < k; j++) dst[j] = src[j] < 0 ? 0 : lut[src[j]];
  }

  // -- opening --

  // The header (or, without one, nothing) and the column mapping;
  // returns false with `error` set.
  bool open(const char* const* names, const int32_t* types, int32_t ncols,
            const uint8_t* active, bool has_header) {
    file = fopen(path.c_str(), "rb");
    if (!file) {
      error = "cannot open " + path;
      return false;
    }
    struct stat st;
    if (fstat(fileno(file), &st) == 0) {  // no more workers than blocks
      size_t blocks = static_cast<size_t>(st.st_size) / block_size + 1;
      if (blocks < static_cast<size_t>(threads)) threads = static_cast<int>(blocks);
    }
    schema_to_out.assign(ncols, -1);
    for (int32_t i = 0; i < ncols; i++) {
      if (active && !active[i]) continue;
      if (types[i] < T_BOOL || types[i] > T_UTF8) {
        error = "unknown column type " + std::to_string(types[i]);
        return false;
      }
      schema_to_out[i] = static_cast<int32_t>(out.size());
      out.push_back({types[i], names[i], type_width(types[i])});
    }
    try {
      bool more = read_more(carry, block_size);
      if (carry.compare(0, 3, "\xEF\xBB\xBF") == 0) carry.erase(0, 3);
      if (carry.empty() && !more) {
        error = "Empty CSV file " + path;
        return false;
      }
      if (has_header) {
        size_t cut;
        while ((cut = first_record_end(carry, more)) == 0 && more)
          more = read_more(carry, std::max(block_size, carry.size()));
        std::vector<FieldRef> fields;
        std::string scratch;
        const char* p = carry.data();
        int r = next_record(p, carry.data() + cut, fields, scratch);
        if (r <= 0) {
          error = r == 0 ? "CSV file " + path + " has no header row"
                         : "unterminated quoted field in the header of " + path;
          return false;
        }
        nfile = fields.size();
        file_to_out.assign(nfile, -1);
        for (int32_t i = 0; i < ncols; i++) {
          int32_t s = schema_to_out[i];
          if (s < 0) continue;
          size_t f = 0;
          while (f < nfile && std::string_view(fields[f].p, fields[f].n) != names[i]) f++;
          if (f == nfile) {
            error = std::string("column '") + names[i] + "' is not in the header of " + path;
            return false;
          }
          if (file_to_out[f] < 0) file_to_out[f] = s;
        }
        // a schema column whose header name repeats reads its first field
        carry.erase(0, cut);
      } else {
        nfile = ncols;
        file_to_out.assign(schema_to_out.begin(), schema_to_out.end());
      }
    } catch (const std::exception& e) {
      error = e.what();
      return false;
    }
    next_local.assign(out.size(), 0);
    luts.assign(out.size(), {});
    batch_data.resize(out.size());
    batch_valid.resize(out.size());
    batch_any_null.assign(out.size(), false);
    dicts.resize(out.size());
    for (size_t s = 0; s < out.size(); s++) {
      batch_data[s].resize(batch_size * out[s].width);
      batch_valid[s].resize(batch_size);
    }
    return true;
  }

  // The offset past the first record of buf (blank lines before it
  // included), 0 if the buffer holds no whole record yet; at the end of
  // the file the buffer's end.
  static size_t first_record_end(const std::string& buf, bool more) {
    size_t i = 0;
    while (i < buf.size() && (buf[i] == '\n' || buf[i] == '\r')) i++;
    bool quoted = false;
    for (size_t j = i; j < buf.size(); j++) {
      char c = buf[j];
      if (c == '"') {
        if (quoted) {
          if (j + 1 < buf.size() && buf[j + 1] == '"') j++;
          else quoted = false;
        } else if (j == i || buf[j - 1] == ',') {
          quoted = true;
        }
      } else if (!quoted && (c == '\n' || c == '\r')) {
        if (c == '\r' && j + 1 < buf.size() && buf[j + 1] == '\n') j++;
        return j + 1;
      }
    }
    return more ? 0 : buf.size();
  }
};

}  // namespace

extern "C" {

// `names` and `col_types`: the schema's ncols columns (names UTF-8);
// `active`: an optional projection mask (1 = convert and return), NULL
// for every column.  The caller checks dtf_csv_error before
// dtf_csv_next.
void* dtf_csv_open(const char* path, int32_t ncols, const char* const* names,
                   const int32_t* col_types, int32_t has_header, int64_t batch_size,
                   const uint8_t* active, int64_t block_size, int32_t threads) {
  auto* r = new Reader();
  r->path = path;
  r->batch_size = batch_size;
  r->block_size = static_cast<size_t>(std::max<int64_t>(block_size, 1));
  r->threads = std::max(threads, 1);
  r->open(names, col_types, ncols, active, has_header != 0);
  return r;
}

const char* dtf_csv_error(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return r->error.empty() ? nullptr : r->error.c_str();
}

// The next batch's row count: batch_size but for the last batch, 0 at
// the end of the file, -1 on an error (dtf_csv_error says which).
int64_t dtf_csv_next(void* handle) { return static_cast<Reader*>(handle)->next(); }

// Schema column i's values in the batch (Utf8: int32 codes into the
// column's dictionary, 0 for NULL); valid until the next dtf_csv_next.
void* dtf_csv_col_data(void* handle, int32_t i) {
  auto* r = static_cast<Reader*>(handle);
  return r->batch_data[r->schema_to_out[i]].data();
}

// A validity byte a row, or NULL when every row of the batch is valid.
uint8_t* dtf_csv_col_validity(void* handle, int32_t i) {
  auto* r = static_cast<Reader*>(handle);
  int32_t s = r->schema_to_out[i];
  return r->batch_any_null[s] ? r->batch_valid[s].data() : nullptr;
}

// Column i's dictionary so far: its size, then its strings as one
// buffer and size + 1 offsets into it.
int32_t dtf_csv_dict_size(void* handle, int32_t i) {
  auto* r = static_cast<Reader*>(handle);
  return static_cast<int32_t>(r->dicts[r->schema_to_out[i]].offsets.size() - 1);
}

const char* dtf_csv_dict_bytes(void* handle, int32_t i) {
  auto* r = static_cast<Reader*>(handle);
  return r->dicts[r->schema_to_out[i]].arena.data();
}

const int64_t* dtf_csv_dict_offsets(void* handle, int32_t i) {
  auto* r = static_cast<Reader*>(handle);
  return r->dicts[r->schema_to_out[i]].offsets.data();
}

void dtf_csv_close(void* handle) { delete static_cast<Reader*>(handle); }

}  // extern "C"
