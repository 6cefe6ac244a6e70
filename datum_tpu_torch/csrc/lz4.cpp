// LZ4 block codec of the port's pack pipeline (the same code as
// datum_tpu/native/lz4.cpp; a test holds the two byte for byte).
//
// Standalone implementation of the LZ4 block format, the wire format of
// the CDAT chunks in .pack asset files (16 KB blocks).  Exposed with a C
// ABI for ctypes (datum_tpu_torch/asset/lz4.py), which builds this file
// with g++ at first use.  The compressor is a greedy single-probe hash
// matcher: small, fast, and its streams are valid for any LZ4 decoder.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;       // last 12 bytes of input must be literals
constexpr int LASTLITERALS = 5;   // last 5 output bytes must be literals
constexpr int HASH_LOG = 13;

inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - HASH_LOG);
}

}  // namespace

extern "C" {

// Decompress an LZ4 block. Returns bytes written to dst, or -1 on error.
// Stops after writing at most dstcap bytes (inputs are trusted pack data,
// but we still bound every write).
long datum_lz4_decompress(const uint8_t *src, long srclen, uint8_t *dst, long dstcap) {
  const uint8_t *ip = src;
  const uint8_t *iend = src + srclen;
  uint8_t *op = dst;
  uint8_t *oend = dst + dstcap;

  while (ip < iend) {
    unsigned token = *ip++;

    // literals
    long litlen = token >> 4;
    if (litlen == 15) {
      unsigned s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        litlen += s;
      } while (s == 255);
    }
    if (ip + litlen > iend || op + litlen > oend) return -1;
    std::memcpy(op, ip, litlen);
    ip += litlen;
    op += litlen;

    if (ip >= iend) break;  // end of block after literals

    // match
    if (ip + 2 > iend) return -1;
    unsigned offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < (long)offset) return -1;

    long matchlen = token & 15;
    if (matchlen == 15) {
      unsigned s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        matchlen += s;
      } while (s == 255);
    }
    matchlen += MINMATCH;
    if (op + matchlen > oend) return -1;

    const uint8_t *match = op - offset;
    if (offset >= 8) {
      // non-overlapping fast path
      long n = matchlen;
      while (n >= 8) {
        std::memcpy(op, match, 8);
        op += 8;
        match += 8;
        n -= 8;
      }
      while (n--) *op++ = *match++;
    } else {
      for (long i = 0; i < matchlen; ++i) op[i] = match[i];
      op += matchlen;
    }
  }
  return op - dst;
}

// Compress up to *srclen bytes of src into dst (capacity dstcap).
// On return *srclen holds the number of input bytes actually consumed
// (mirrors the reference packer contract where a 16KB output block
// consumes as much input as fits; reference: tools/assetpacker.cpp
// write_compressed_chunk).  Returns the compressed size.
long datum_lz4_compress(const uint8_t *src, long *srclen, uint8_t *dst, long dstcap) {
  long insize = *srclen;
  const uint8_t *ip = src;
  const uint8_t *iend = src + insize;
  const uint8_t *mflimit = iend - MFLIMIT;
  uint8_t *op = dst;
  uint8_t *oend = dst + dstcap;

  int32_t table[1 << HASH_LOG];
  for (auto &t : table) t = -1;

  const uint8_t *anchor = ip;

  auto emit = [&](const uint8_t *lit_start, long litlen, unsigned offset, long matchlen) -> bool {
    // worst-case size of this sequence
    long need = 1 + (litlen >= 15 ? 1 + litlen / 255 : 0) + litlen +
                (matchlen > 0 ? 2 + (matchlen - MINMATCH >= 15 ? 1 + (matchlen - MINMATCH) / 255 : 0) : 0);
    // reserve one byte so the stream can always be closed with an
    // empty-literal token
    if (op + need + 1 > oend) return false;

    uint8_t *token = op++;
    long ml = matchlen > 0 ? matchlen - MINMATCH : 0;
    *token = (uint8_t)((litlen >= 15 ? 15 : litlen) << 4 | (matchlen > 0 ? (ml >= 15 ? 15 : ml) : 0));
    if (litlen >= 15) {
      long rem = litlen - 15;
      while (rem >= 255) { *op++ = 255; rem -= 255; }
      *op++ = (uint8_t)rem;
    }
    std::memcpy(op, lit_start, litlen);
    op += litlen;
    if (matchlen > 0) {
      *op++ = (uint8_t)(offset & 0xFF);
      *op++ = (uint8_t)(offset >> 8);
      if (ml >= 15) {
        long rem = ml - 15;
        while (rem >= 255) { *op++ = 255; rem -= 255; }
        *op++ = (uint8_t)rem;
      }
    }
    return true;
  };

  if (insize >= MFLIMIT) {
    while (ip < mflimit) {
      uint32_t h = hash4(read32(ip));
      long cand = table[h];
      table[h] = (int32_t)(ip - src);

      if (cand >= 0 && ip - (src + cand) <= 0xFFFF && read32(src + cand) == read32(ip)) {
        // extend match
        const uint8_t *match = src + cand;
        const uint8_t *mp = match + MINMATCH;
        const uint8_t *cp = ip + MINMATCH;
        while (cp < iend - LASTLITERALS && *cp == *mp) { ++cp; ++mp; }
        long matchlen = cp - ip;
        long litlen = ip - anchor;

        uint8_t *save_op = op;
        if (!emit(anchor, litlen, (unsigned)(ip - match), matchlen)) {
          op = save_op;
          goto finish;  // output full: stop consuming here
        }
        ip = cp;
        anchor = ip;
      } else {
        ++ip;
      }
    }
  }

finish:
  // trailing literals for everything from anchor to end of consumed input
  {
    long litlen = iend - anchor;
    // ensure the final literal run fits; if not, shrink consumed input
    while (litlen > 0) {
      long need = 1 + (litlen >= 15 ? 1 + litlen / 255 : 0) + litlen;
      if (op + need <= oend) break;
      --litlen;
      --iend;
    }
    if (anchor == src && litlen == 0) {
      // nothing fit (or empty input with no room for the end token)
      *srclen = 0;
      return 0;
    }
    uint8_t *token = op++;
    *token = (uint8_t)((litlen >= 15 ? 15 : litlen) << 4);
    if (litlen >= 15) {
      long rem = litlen - 15;
      while (rem >= 255) { *op++ = 255; rem -= 255; }
      *op++ = (uint8_t)rem;
    }
    std::memcpy(op, anchor, litlen);
    op += litlen;
    *srclen = (anchor - src) + litlen;
  }
  return op - dst;
}

}  // extern "C"
