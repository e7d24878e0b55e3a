"""Write the tables RFC 7932 (Brotli) fixes, for the port's BROTLI page
decoder (`datafusion_tpu_torch/native/codecs.cpp`):

    python3 scripts/port_brotli_dictionary.py [LIBBROTLICOMMON]

It loads libbrotlicommon (default `libbrotlicommon.so.1`, found by the
dynamic loader; brotli 1.0.9 was used) through ctypes, reads

- the static dictionary (Appendix A) through `BrotliGetDictionary()`,
  checked against its length, 122,784 bytes, its SHA-256 (`SHA256`) and
  the word counts by length of section 8 (`NDBITS`);
- the 121 word transforms (Appendix B) through `BrotliGetTransforms()`:
  prefix, transform type, suffix;
- the literal context lookup tables (section 7.1) from
  `_kBrotliContextLookupTable`,

and writes them as `datafusion_tpu_torch/native/brotli_dictionary.cpp`,
a source the port's first-use build compiles with the others (no
library is linked at run time).  The output is deterministic: running
the script again rewrites the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "datafusion_tpu_torch", "native", "brotli_dictionary.cpp")
SIZE = 122_784
SHA256 = "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70"
# log2 of the number of words of each length 4 to 24 (RFC 7932, section 8)
NDBITS = (10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8, 7, 7, 8, 7, 7, 6, 6, 5, 5)
TRANSFORMS = 121


class _Dictionary(ctypes.Structure):  # BrotliDictionary, common/dictionary.h
    _fields_ = [("size_bits_by_length", ctypes.c_uint8 * 32),
                ("offsets_by_length", ctypes.c_uint32 * 32),
                ("data_size", ctypes.c_size_t),
                ("data", ctypes.POINTER(ctypes.c_uint8))]


class _Transforms(ctypes.Structure):  # BrotliTransforms, common/transform.h
    _fields_ = [("prefix_suffix_size", ctypes.c_uint16),
                ("prefix_suffix", ctypes.POINTER(ctypes.c_uint8)),
                ("prefix_suffix_map", ctypes.POINTER(ctypes.c_uint16)),
                ("num_transforms", ctypes.c_uint32),
                ("transforms", ctypes.POINTER(ctypes.c_uint8)),
                ("params", ctypes.c_void_p),
                ("cutOffTransforms", ctypes.c_int16 * 10)]


def extract(lib_name: str = "libbrotlicommon.so.1"):
    """(dictionary bytes, [(prefix, type, suffix)] * 121, context LUT of
    2048 bytes) from the library, each checked against the RFC."""
    lib = ctypes.CDLL(lib_name)
    lib.BrotliGetDictionary.restype = ctypes.POINTER(_Dictionary)
    d = lib.BrotliGetDictionary().contents
    data = ctypes.string_at(d.data, d.data_size)
    if len(data) != SIZE or hashlib.sha256(data).hexdigest() != SHA256:
        raise SystemExit(f"{lib_name}: a dictionary of {len(data)} bytes, SHA-256 "
                         f"{hashlib.sha256(data).hexdigest()}; RFC 7932's is {SIZE}, {SHA256}")
    offset = 0
    for length, bits in zip(range(4, 25), NDBITS):
        if d.size_bits_by_length[length] != bits or d.offsets_by_length[length] != offset:
            raise SystemExit(f"{lib_name}: words of length {length} disagree with RFC 7932")
        offset += length << bits
    if offset != SIZE:
        raise SystemExit("NDBITS does not cover the dictionary")

    lib.BrotliGetTransforms.restype = ctypes.POINTER(_Transforms)
    t = lib.BrotliGetTransforms().contents
    if t.num_transforms != TRANSFORMS or t.params:
        raise SystemExit(f"{lib_name}: {t.num_transforms} transforms, not RFC 7932's 121")
    table = ctypes.string_at(t.prefix_suffix, t.prefix_suffix_size)

    def piece(i):
        at = t.prefix_suffix_map[i]
        return table[at + 1:at + 1 + table[at]]  # length-prefixed

    transforms = []
    for i in range(TRANSFORMS):
        kind = t.transforms[3 * i + 1]
        if kind > 20:  # identity, omit last 1-9, uppercase first, all, omit first 1-9
            raise SystemExit(f"{lib_name}: transform {i} has type {kind}")
        transforms.append((piece(t.transforms[3 * i]), kind, piece(t.transforms[3 * i + 2])))

    lut_t = ctypes.c_uint8 * 2048
    lut = bytes(lut_t.in_dll(lib, "_kBrotliContextLookupTable"))
    return data, transforms, lut


def c_string(raw: bytes) -> str:
    """`raw` as the body of a C++ string literal: printable ASCII as is,
    everything else (and `"`, `\\`, `?`) as a three-digit octal escape."""
    out = []
    for b in raw:
        if 0x20 <= b < 0x7F and b not in b'"\\?':
            out.append(chr(b))
        else:
            out.append(f"\\{b:03o}")
    return "".join(out)


def render(data: bytes, transforms, lut: bytes) -> str:
    lines = [
        "// RFC 7932 (Brotli): the static dictionary (Appendix A), the word",
        "// transforms (Appendix B) and the literal context lookup tables",
        "// (section 7.1), for the BROTLI page decoder of codecs.cpp.",
        "// Generated by scripts/port_brotli_dictionary.py from libbrotlicommon's",
        "// BrotliGetDictionary(), BrotliGetTransforms() and",
        "// _kBrotliContextLookupTable; do not edit.",
        f"// Dictionary: {SIZE} bytes, SHA-256 {SHA256}.",
        "",
        "#include <cstdint>",
        "",
        "namespace dtf_codec {",
        "",
        "struct BrotliTransform {",
        "  uint8_t prefix_len;",
        "  const char* prefix;",
        "  uint8_t type;  // 0 identity, 1-9 omit last k, 10 uppercase first,",
        "                 // 11 uppercase all, 12-20 omit first k - 11",
        "  uint8_t suffix_len;",
        "  const char* suffix;",
        "};",
        "",
        f"extern const char kBrotliDictionary[{SIZE + 1}];",
        f"extern const BrotliTransform kBrotliTransforms[{TRANSFORMS}];",
        "extern const uint8_t kBrotliContextLut[2048];",
        "",
        f"const char kBrotliDictionary[{SIZE + 1}] =",
    ]
    step = 96
    for lo in range(0, len(data), step):
        end = ";" if lo + step >= len(data) else ""
        lines.append(f'    "{c_string(data[lo:lo + step])}"{end}')
    lines += ["", f"const BrotliTransform kBrotliTransforms[{TRANSFORMS}] = {{"]
    for prefix, kind, suffix in transforms:
        lines.append(f'    {{{len(prefix)}, "{c_string(prefix)}", {kind}, {len(suffix)}, '
                     f'"{c_string(suffix)}"}},')
    lines += ["};", "", "// [mode << 9 | p1] | [mode << 9 | 256 | p2]: LSB6, MSB6, UTF8, signed",
              "const uint8_t kBrotliContextLut[2048] = {"]
    for lo in range(0, len(lut), 16):
        lines.append("    " + ", ".join(str(b) for b in lut[lo:lo + 16]) + ",")
    lines += ["};", "", "}  // namespace dtf_codec", ""]
    return "\n".join(lines)


def parse_dictionary(path: str = OUT) -> bytes:
    """The dictionary bytes a generated source holds (its literal
    decoded), for checking a committed file against the library."""
    lines = open(path, encoding="ascii").read().splitlines()
    first = lines.index(f"const char kBrotliDictionary[{SIZE + 1}] =") + 1
    out = bytearray()
    for line in lines[first:]:
        s = line.strip()
        last = s.endswith('";')
        s = s[1:-2] if last else s[1:-1]
        i = 0
        while i < len(s):
            if s[i] == "\\":
                out.append(int(s[i + 1:i + 4], 8))
                i += 4
            else:
                out.append(ord(s[i]))
                i += 1
        if last:
            break
    return bytes(out)


def main(argv) -> int:
    data, transforms, lut = extract(argv[1] if len(argv) > 1 else "libbrotlicommon.so.1")
    with open(OUT, "w", encoding="ascii") as f:
        f.write(render(data, transforms, lut))
    if parse_dictionary(OUT) != data:
        raise SystemExit(f"{OUT} does not read back as the dictionary")
    print(f"{OUT}: dictionary {len(data)} bytes (SHA-256 {SHA256}), "
          f"{len(transforms)} transforms, context tables {len(lut)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
