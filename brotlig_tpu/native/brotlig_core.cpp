// Native CPU Brotli-G decoder: the host-side runtime of the JAX framework.
//
// Fresh implementation of the Brotli-G format (parity references:
// src/decoder/PageDecoder.cpp, src/decoder/BrotligHuffmanTable.cpp,
// inc/common/BrotligDeswizzler.h of GPUOpen brotli_g_sdk; the bitstream
// layout is documented in this repo's SURVEY.md Appendix A). Used for:
//  * fast host-side decode fallback / oracle cross-check
//  * measuring the "reference CPU decoder" baseline on this host
//  * multithreaded page-parallel decode (atomic work index, as the
//    reference's worker pool does).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kNumStreams = 32;
constexpr int kTableBits = 15;
constexpr int kTableSize = 1 << kTableBits;
constexpr int kClTableBits = 9;
constexpr uint32_t kNumCommandSymbols = 704;
constexpr uint32_t kCmdAlphabet = 728;   // 704 + sentinel + 23 insert-only
constexpr uint32_t kDistAlphabet = 544;
constexpr uint32_t kLitAlphabet = 256;

// RFC 7932 length code tables
constexpr uint32_t kInsBase[24] = {0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26,
                                   34, 50, 66, 98, 130, 194, 322, 578,
                                   1090, 2114, 6210, 22594};
constexpr uint32_t kInsExtra[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                    4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
constexpr uint32_t kCpyBase[24] = {2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18,
                                   22, 30, 38, 54, 70, 102, 134, 198, 326,
                                   582, 1094, 2118};
constexpr uint32_t kCpyExtra[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3,
                                    3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};
constexpr int kClOrder[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16,
                              7, 8, 9, 10, 11, 12, 13, 14, 15};

inline uint32_t BitLength(uint32_t x) { return x ? 32 - __builtin_clz(x) : 0; }

inline uint32_t Reverse16(uint32_t v) {
  v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555);
  v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333);
  v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F);
  v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF);
  return v;
}
inline uint32_t Reverse15(uint32_t v) { return Reverse16(v << 1) & 0x7FFF; }
inline uint32_t Reverse9(uint32_t v) { return Reverse16(v << 7) & 0x1FF; }

// LSB-first bit reader over a bounded buffer (reads past end yield zeros).
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t bitpos = 0;

  uint64_t Load64(size_t byte) const {
    uint64_t v = 0;
    size_t n = size > byte ? size - byte : 0;
    if (n > 8) n = 8;
    std::memcpy(&v, data + byte, n);  // little-endian
    return v;
  }
  uint32_t Peek(uint32_t nbits) const {
    if (!nbits) return 0;
    uint64_t w = Load64(bitpos >> 3) >> (bitpos & 7);
    return static_cast<uint32_t>(w) & ((1u << nbits) - 1);
  }
  uint32_t Read(uint32_t nbits) {
    uint32_t v = Peek(nbits);
    bitpos += nbits;
    return v;
  }
};

// 32-lane round-robin deswizzler (semantics of BrotligDeswizzler.h).
struct Deswizzler {
  BitReader lanes[kNumStreams];
  int cur = 0;
  uint32_t Read(uint32_t n) { return lanes[cur].Read(n); }
  uint32_t Peek(uint32_t n) const { return lanes[cur].Peek(n); }
  void Consume(uint32_t n) { lanes[cur].bitpos += n; }
  void Switch() { cur = (cur + 1) & 31; }
  void Reset() { cur = 0; }
};

// Flat direct-lookup decode table: entry = symbol<<5 | len.
struct Table {
  std::vector<uint32_t> flat;
  int32_t trivial = -1;
  bool BuildFromLengths(const uint8_t* lens, uint32_t alphabet) {
    flat.assign(kTableSize, 0);
    uint32_t bl_count[16] = {0};
    for (uint32_t s = 0; s < alphabet; ++s) {
      if (lens[s] > 15) return false;  // corrupt input
      bl_count[lens[s]]++;
    }
    bl_count[0] = 0;
    uint32_t next_code[17] = {0};
    for (int l = 1; l <= 15; ++l)
      next_code[l] = (next_code[l - 1] + bl_count[l - 1]) << 1;
    for (uint32_t s = 0; s < alphabet; ++s) {
      uint32_t L = lens[s];
      if (!L) continue;
      uint32_t code = next_code[L]++;
      uint64_t start = static_cast<uint64_t>(code) << (kTableBits - L);
      uint64_t span = 1u << (kTableBits - L);
      if (start + span > kTableSize) return false;  // over-subscribed code
      uint32_t entry = (s << 5) | L;
      for (uint64_t i = 0; i < span; ++i) flat[start + i] = entry;
    }
    return true;
  }
};

// Parse one Huffman table (3 storage modes; BrotligHuffmanTable.cpp:73-205).
bool LoadTable(Deswizzler& r, uint32_t alphabet, Table& out) {
  const uint32_t max_bits = BitLength(alphabet - 1);
  uint32_t ttype = r.Read(2);
  if (ttype == 0) {  // trivial
    r.Consume(4);
    out.trivial = static_cast<int32_t>(r.Read(max_bits));
    r.Reset();
    return true;
  }
  out.trivial = -1;
  std::vector<uint8_t> lens(alphabet, 0);
  if (ttype == 1) {  // simple, 2..4 symbols with fixed shapes
    uint32_t nsym = r.Read(2) + 1;
    uint32_t tsel = r.Read(1);
    r.Consume(1);
    static const uint8_t kFixed[4][4] = {
        {1, 1, 0, 0}, {1, 2, 2, 0}, {2, 2, 2, 2}, {1, 2, 3, 3}};
    uint32_t row = nsym < 4 ? nsym - 2 : (tsel ? 3 : 2);
    for (uint32_t i = 0; i < nsym; ++i) {
      uint32_t sym = r.Read(max_bits);
      if (sym >= alphabet) return false;
      lens[sym] = kFixed[row][i];
      r.Switch();
    }
    r.Reset();
  } else if (ttype == 2) {  // complex: RLE-coded code lengths
    uint32_t nlen = r.Read(4) + 4;
    uint8_t cl_lens[18] = {0};
    for (uint32_t i = 0; i < nlen && i < 18; ++i) {
      cl_lens[kClOrder[i]] = static_cast<uint8_t>(r.Read(5));
      r.Switch();
    }
    r.Reset();
    // 9-bit flat table for the code-length code
    uint16_t cl_flat[1 << kClTableBits] = {0};
    {
      uint32_t blc[10] = {0};
      for (int s = 0; s < 18; ++s) {
        if (cl_lens[s] > 9) return false;  // corrupt input
        blc[cl_lens[s]]++;
      }
      blc[0] = 0;
      uint32_t next[11] = {0};
      for (int l = 1; l <= 9; ++l) next[l] = (next[l - 1] + blc[l - 1]) << 1;
      for (int s = 0; s < 18; ++s) {
        uint32_t L = cl_lens[s];
        if (!L) continue;
        uint32_t code = next[L]++;
        uint64_t start = static_cast<uint64_t>(code) << (kClTableBits - L);
        uint64_t span = 1u << (kClTableBits - L);
        if (start + span > (1u << kClTableBits)) return false;
        for (uint64_t i = 0; i < span; ++i)
          cl_flat[start + i] = static_cast<uint16_t>((s << 5) | L);
      }
    }
    uint32_t prev = 8, pos = 0;
    int64_t left = alphabet;
    while (left > 0) {
      uint32_t idx = Reverse9(r.Peek(9));
      uint32_t sym = cl_flat[idx] >> 5, L = cl_flat[idx] & 31;
      r.Consume(L);
      if (sym == 16) {
        uint32_t reps = r.Read(2) + 3;
        if (reps > left) return false;
        for (uint32_t i = 0; i < reps; ++i) lens[pos++] = prev;
        left -= reps;
      } else if (sym == 17) {
        uint32_t reps = r.Read(3) + 3;
        if (reps > left) return false;
        pos += reps;
        left -= reps;
      } else {
        lens[pos++] = static_cast<uint8_t>(sym);
        prev = sym;
        --left;
      }
      r.Switch();
    }
    r.Reset();
  } else {
    return false;
  }
  return out.BuildFromLengths(lens.data(), alphabet);
}

struct Command {
  uint32_t insert_len, copy_len, dist;
};

// Decode one compressed page (PageDecoder.cpp:65-268 semantics).
bool DecodePage(const uint8_t* src, size_t src_size, uint8_t* dst,
                size_t dst_size) {
  BitReader hdr{src, src_size + 8};
  uint32_t npostfix = hdr.Read(2);
  uint32_t ndirect = hdr.Read(4) << npostfix;
  hdr.Read(1);  // isdelta (handled by the caller)
  hdr.Read(1);

  // self-describing size table
  uint32_t r_avg = (static_cast<uint32_t>(src_size) + 31) / 32;
  uint32_t base_bits = BitLength(r_avg);
  uint32_t dlt_bits_bits = BitLength(BitLength(
      static_cast<uint32_t>(src_size - 1)));
  uint32_t base = hdr.Read(base_bits);
  uint32_t dlt_bits = hdr.Read(dlt_bits_bits);
  size_t header_bits = 8 + base_bits + dlt_bits_bits + 32u * dlt_bits;
  header_bits = (header_bits + 31) / 32 * 32;

  Deswizzler r;
  size_t off = header_bits / 8;
  for (int s = 0; s < kNumStreams; ++s) {
    uint32_t d = hdr.Read(dlt_bits);
    r.lanes[s] = BitReader{src, src_size + 16, off * 8};
    off += base + d;
  }

  Table icp, dist_t, lit;
  if (!LoadTable(r, kCmdAlphabet, icp)) return false;
  if (!LoadTable(r, kDistAlphabet, dist_t)) return false;
  if (!LoadTable(r, kLitAlphabet, lit)) return false;

  auto decode = [&](const Table& t) -> uint32_t {
    if (t.trivial >= 0) return static_cast<uint32_t>(t.trivial);
    uint32_t e = t.flat[Reverse15(r.Peek(15))];
    r.Consume(e & 31);
    return e >> 5;
  };

  uint32_t ring[4] = {4, 11, 15, 16};
  std::vector<uint8_t> litq;
  litq.reserve(dst_size + 64);
  size_t lq_front = 0;
  size_t wpos = 0;
  uint32_t prev_tail = 0;
  bool sentinel = false;
  Command cmds[kNumStreams];
  // corrupt streams may never produce a sentinel: bound the rounds
  int64_t rounds_left = static_cast<int64_t>(dst_size / 2 + 34);

  while (!sentinel) {
    if (--rounds_left < 0) return false;
    uint32_t litcount = 0, bs = 0;
    while (bs != kNumStreams) {
      uint32_t sym = decode(icp);
      uint32_t ins, cpy, d = 0;
      if (sym <= kNumCommandSymbols) {
        if (sym == kNumCommandSymbols) { sentinel = true; break; }
        // split combined code into insert/copy codes (RFC 7932 sec. 5
        // command code table, blocks of 64)
        static const uint8_t kInsHigh[9] = {0, 0, 1, 1, 0, 2, 1, 2, 2};
        static const uint8_t kCpyHigh[9] = {0, 1, 0, 1, 2, 0, 2, 1, 2};
        uint32_t inscode, cpycode;
        if (sym < 128) {
          inscode = (sym >> 3) & 7;
          cpycode = (sym & 7) + ((sym >= 64) ? 8 : 0);
        } else {
          uint32_t cell = (sym >> 6) - 2;
          inscode = (kInsHigh[cell] << 3) | ((sym >> 3) & 7);
          cpycode = (kCpyHigh[cell] << 3) | (sym & 7);
        }
        ins = kInsBase[inscode] + r.Read(kInsExtra[inscode]);
        cpy = kCpyBase[cpycode] + r.Read(kCpyExtra[cpycode]);
        uint32_t dcode = 0;
        if (sym >= 128) dcode = decode(dist_t);
        // distance translation (PageDecoder.cpp:345-404)
        if (dcode == 0) {
          d = ring[0];
        } else if (dcode < 4) {
          d = ring[dcode];
        } else if (dcode < 16) {
          uint32_t r0 = dcode < 10 ? ring[0] : ring[1];
          uint32_t base4 = (dcode - 4) % 6;
          int32_t mag = base4 / 2 + 1;
          d = (dcode & 1) ? r0 + mag : r0 - mag;
        } else if (ndirect > 0 && dcode < 16 + ndirect) {
          d = dcode - 15;
        } else {
          uint32_t s2 = dcode - ndirect - 16;
          uint32_t nb = 1 + (s2 >> (npostfix + 1));
          uint32_t extra = r.Read(nb);
          uint32_t hc = s2 >> npostfix, lc = s2 & ((1u << npostfix) - 1);
          uint32_t o = ((2 + (hc & 1)) << nb) - 4;
          d = ((o + extra) << npostfix) + lc + ndirect + 1;
        }
        if (dcode > 0) {
          ring[3] = ring[2]; ring[2] = ring[1]; ring[1] = ring[0];
          ring[0] = d;
        }
      } else {  // insert-only tail command
        uint32_t inscode = sym - kNumCommandSymbols;
        if (inscode > 23) return false;
        ins = kInsBase[inscode] + r.Read(kInsExtra[inscode]);
        cpy = 0;
      }
      litcount += ins;
      cmds[bs] = {ins, cpy, d};
      ++bs;
      r.Switch();
    }
    r.Reset();

    // A valid page's inserts never exceed the bytes left to write; checking
    // here (not after the fill) stops a corrupt page from declaring ~16.8M
    // inserts per command and forcing a ~0.5 GB transient literal fill.
    if (litcount > dst_size - wpos) return false;

    uint32_t aclit = litcount > prev_tail ? litcount - prev_tail : 0;
    uint32_t mult = bs ? (aclit + bs - 1) / bs : 0;
    uint32_t rlit = bs * mult;
    prev_tail = rlit + prev_tail - litcount;

    for (uint32_t i = 0; i < rlit; ++i) {
      litq.push_back(static_cast<uint8_t>(decode(lit)));
      r.Switch();
    }

    for (uint32_t c = 0; c < bs; ++c) {
      Command& cm = cmds[c];
      if (cm.insert_len) {
        if (wpos + cm.insert_len > dst_size ||
            lq_front + cm.insert_len > litq.size())
          return false;
        std::memcpy(dst + wpos, litq.data() + lq_front, cm.insert_len);
        wpos += cm.insert_len;
        lq_front += cm.insert_len;
      }
      if (cm.copy_len) {
        if (cm.dist > wpos || wpos + cm.copy_len > dst_size) return false;
        const uint8_t* s2 = dst + wpos - cm.dist;
        uint8_t* d2 = dst + wpos;
        if (cm.dist >= cm.copy_len) {
          std::memcpy(d2, s2, cm.copy_len);
        } else {
          for (uint32_t i = 0; i < cm.copy_len; ++i) d2[i] = s2[i];
        }
        wpos += cm.copy_len;
      }
    }
    r.Reset();
  }
  return wpos == dst_size;
}

struct StreamInfo {
  uint32_t num_pages, page_size, last_page_size;
  bool preconditioned;
  size_t table_off;
};

bool ParseHeader(const uint8_t* src, size_t n, StreamInfo& si) {
  if (n < 8) return false;
  if (src[0] != 5 || src[1] != (5 ^ 0xFF)) return false;
  si.num_pages = src[2] | (src[3] << 8);
  uint32_t bits;
  std::memcpy(&bits, src + 4, 4);
  si.page_size = 32768u << (bits & 3);
  si.last_page_size = (bits >> 2) & 0x3FFFF;
  si.preconditioned = (bits >> 20) & 1;
  si.table_off = 8 + (si.preconditioned ? 8 : 0);
  return true;
}

}  // namespace

extern "C" {

// Returns decompressed size or 0 on parse error.
uint64_t blg_decompressed_size(const uint8_t* src, uint64_t n) {
  StreamInfo si;
  if (!ParseHeader(src, n, si)) return 0;
  if (si.num_pages == 0) return 0;
  return static_cast<uint64_t>(si.num_pages) * si.page_size -
         (si.last_page_size ? si.page_size - si.last_page_size : 0);
}

// Decode a full (non-preconditioned) container. Returns 0 on success.
// Multithreaded over pages with an atomic work index; num_threads<=0 means
// hardware concurrency (capped at 128 like the reference worker pool).
int blg_decode(const uint8_t* src, uint64_t src_size, uint8_t* dst,
               uint64_t dst_cap, uint64_t* out_size, int num_threads) {
  StreamInfo si;
  if (!ParseHeader(src, src_size, si)) return 1;
  if (si.preconditioned) return 2;  // python layer handles deconditioning
  uint64_t total = blg_decompressed_size(src, src_size);
  if (si.num_pages == 0) { *out_size = 0; return 0; }
  if (total > dst_cap) return 3;

  if (src_size < si.table_off + 4ull * si.num_pages) return 1;
  const uint32_t* table =
      reinterpret_cast<const uint32_t*>(src + si.table_off);
  const uint8_t* payload = src + si.table_off + 4ull * si.num_pages;
  const uint64_t payload_size = src_size - si.table_off
      - 4ull * si.num_pages;

  std::atomic<uint32_t> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    for (;;) {
      uint32_t i = next.fetch_add(1);
      if (i >= si.num_pages || err.load()) break;
      uint64_t off = (i == 0) ? 0 : table[i];
      uint64_t end = (i < si.num_pages - 1)
                         ? (i == 0 ? table[1] : table[i + 1])
                         : off + table[0];
      if (end < off || end > payload_size) {  // corrupt page table
        err.store(4);
        break;
      }
      uint64_t sz = end - off;
      uint64_t out_off = static_cast<uint64_t>(i) * si.page_size;
      uint64_t page_out =
          (i == si.num_pages - 1 && si.last_page_size)
              ? si.last_page_size : si.page_size;
      if (sz == page_out) {
        std::memcpy(dst + out_off, payload + off, page_out);
      } else if (!DecodePage(payload + off, sz, dst + out_off, page_out)) {
        err.store(4);
      }
    }
  };
  int nt = num_threads > 0 ? num_threads
                           : static_cast<int>(
                                 std::thread::hardware_concurrency());
  if (nt > 128) nt = 128;
  if (nt < 1) nt = 1;
  if (nt == 1 || si.num_pages < 2) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  if (err.load()) return err.load();
  *out_size = total;
  return 0;
}

// Decode one raw page buffer (for testing / per-page use).
int blg_decode_page(const uint8_t* src, uint64_t src_size, uint8_t* dst,
                    uint64_t dst_size) {
  if (src_size == dst_size) {
    std::memcpy(dst, src, dst_size);
    return 0;
  }
  return DecodePage(src, src_size, dst, dst_size) ? 0 : 4;
}

}  // extern "C"
