// Native host kernels of bionumpy_tpu_torch: the port's own copy of the
// JAX package's csrc/host_kernels.cpp.  For the gzip-FASTQ paths: 2-bit
// packing, byte counting, the fused FASTQ parse + pack, the packed-stream
// stitch and the checksum's row-end correction.  For the file readers
// (io/): the two-byte delimiter scan, BAM record framing, the row gather
// and the integer parse.
// Built with: g++ -O3 -shared -fPIC -pthread host_kernels.cpp inflate.cpp
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// Count bytes in buf equal to a OR b (SIMD; the pre-pass that sizes
// the output of find_two_bytes).
long count_two_bytes(const uint8_t* buf, long n, uint8_t a, uint8_t b) {
    long cnt = 0;
    long i = 0;
#if defined(__x86_64__)
    const __m128i va = _mm_set1_epi8((char)a);
    const __m128i vb = _mm_set1_epi8((char)b);
    for (; i + 16 <= n; i += 16) {
        __m128i t = _mm_loadu_si128((const __m128i*)(buf + i));
        int m = _mm_movemask_epi8(
            _mm_or_si128(_mm_cmpeq_epi8(t, va), _mm_cmpeq_epi8(t, vb)));
        cnt += __builtin_popcount((unsigned)m);
    }
#endif
    for (; i < n; ++i) cnt += (buf[i] == a) | (buf[i] == b);
    return cnt;
}

// Write the positions of bytes equal to a OR b into out (int64,
// capacity must cover the count_two_bytes result).  Returns the count.
// SIMD movemask + ctz in one pass, where numpy's compare chain takes
// three: the hot scan of every delimited text format (VCF/BED/GTF
// newline+tab matrices) and of the one-line formats' newlines.
long find_two_bytes(const uint8_t* buf, long n, uint8_t a, uint8_t b,
                    int64_t* out) {
    long cnt = 0;
    long i = 0;
#if defined(__x86_64__)
    const __m128i va = _mm_set1_epi8((char)a);
    const __m128i vb = _mm_set1_epi8((char)b);
    for (; i + 16 <= n; i += 16) {
        __m128i t = _mm_loadu_si128((const __m128i*)(buf + i));
        int m = _mm_movemask_epi8(
            _mm_or_si128(_mm_cmpeq_epi8(t, va), _mm_cmpeq_epi8(t, vb)));
        while (m) {
            out[cnt++] = i + __builtin_ctz((unsigned)m);
            m &= m - 1;
        }
    }
#endif
    for (; i < n; ++i)
        if (buf[i] == a || buf[i] == b) out[cnt++] = i;
    return cnt;
}

// Returns the number of record starts written to `starts` (capacity
// `max_starts`).  Follows the BAM block-length chain until the next start
// would exceed `n`.  Returns -1 on corrupt (non-advancing) block length.
long bam_find_starts(const uint8_t* chunk, long n, long* starts,
                     long max_starts) {
    long count = 0;
    long pos = 0;
    if (max_starts > 0) {
        starts[count++] = 0;
    }
    while (pos + 4 <= n && count < max_starts) {
        uint32_t block;
        std::memcpy(&block, chunk + pos, 4);  // BAM is little-endian
        long next = pos + 4 + (long)block;
        if (next <= pos) {
            return -1;
        }
        if (next > n) {
            break;
        }
        starts[count++] = next;
        pos = next;
    }
    // one past the end if the final record ends exactly at n is already
    // handled: starts always begin at 0 and include every reachable start
    // <= n
    return count;
}

// Pack 4 codes/byte for out_bytes output bytes starting at code index
// 4*byte_off.  64-bit gather trick: for 8 codes loaded as one uint64,
// t = x | x>>6 packs adjacent pairs into bytes 0/2/4/6, u = t | t>>12
// packs nibble-pairs so bytes 0 and 4 of u are the two output bytes.
static void pack_2bit_range(const uint8_t* codes, long byte_off,
                            long out_bytes, uint8_t* out) {
    const uint8_t* c = codes + 4 * byte_off;
    uint8_t* o = out + byte_off;
    long i = 0;
    for (; i + 2 <= out_bytes; i += 2) {
        uint64_t x;
        std::memcpy(&x, c + 4 * i, 8);
        uint64_t t = x | (x >> 6);
        uint64_t u = t | (t >> 12);
        o[i] = (uint8_t)u;
        o[i + 1] = (uint8_t)(u >> 32);
    }
    for (; i < out_bytes; ++i) {
        const uint8_t* p = c + 4 * i;
        o[i] = (uint8_t)(p[0] | (p[1] << 2) | (p[2] << 4) | (p[3] << 6));
    }
}

// Pack 2-bit codes (values 0..3) into bytes, 4 codes per byte,
// little-endian within the byte.  n must be a multiple of 4.
void pack_2bit(const uint8_t* codes, long n, uint8_t* out) {
    pack_2bit_range(codes, 0, n / 4, out);
}

// Count occurrences of `value` in buf (memchr loop, threaded).  Used
// for newline counting over inflated FASTQ slabs.
static void count_byte_range(const uint8_t* buf, long lo, long hi,
                             uint8_t value, long* out) {
    long c = 0;
    const uint8_t* p = buf + lo;
    const uint8_t* end = buf + hi;
    while (p < end) {
        const uint8_t* q =
            (const uint8_t*)std::memchr(p, value, (size_t)(end - p));
        if (!q) break;
        ++c;
        p = q + 1;
    }
    *out = c;
}

long count_byte(const uint8_t* buf, long n, uint8_t value,
                int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n < (1L << 20)) n_threads = 1;
    if (n_threads == 1) {
        long c = 0;
        count_byte_range(buf, 0, n, value, &c);
        return c;
    }
    std::vector<long> counts((size_t)n_threads, 0);
    std::vector<std::thread> ws;
    long per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        long lo = t * per, hi = lo + per < n ? lo + per : n;
        if (lo >= hi) continue;
        ws.emplace_back(count_byte_range, buf, lo, hi, value, &counts[t]);
    }
    for (auto& w : ws) w.join();
    long total = 0;
    for (long c : counts) total += c;
    return total;
}

// Pack n codes into out[0:out_bytes], zero-filling everything past the
// packed prefix (so callers need no pre-padded copy of the codes).
// Multithreaded over the packed prefix.
void pack_2bit_fill(const uint8_t* codes, long n, uint8_t* out,
                    long out_bytes, int n_threads) {
    long full_bytes = n / 4;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 1 && full_bytes > (1L << 16)) {
        std::vector<std::thread> workers;
        long per = (full_bytes + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            long off = t * per;
            long len = off < full_bytes
                ? (off + per <= full_bytes ? per : full_bytes - off) : 0;
            if (len > 0)
                workers.emplace_back(pack_2bit_range, codes, off, len, out);
        }
        for (auto& w : workers) w.join();
    } else {
        pack_2bit_range(codes, 0, full_bytes, out);
    }
    long pos = full_bytes;
    if (n % 4) {  // trailing partial byte
        uint8_t b = 0;
        for (long j = 0; j < n % 4; ++j)
            b |= (uint8_t)(codes[4 * full_bytes + j] << (2 * j));
        out[pos++] = b;
    }
    if (pos < out_bytes)
        std::memset(out + pos, 0, out_bytes - pos);
}

// ---- k-mer row-end correction -------------------------------------------
//
// The device hot kernel sums hash limbs over ALL flat window positions
// (zero-padded windows hash to 0).  Windows that cross a row boundary are
// invalid under the reference's trim rule (bionumpy/sequence/rollable.py:
// 57-69); there are at most k-1 of them per row, ending at each row end.
// This kernel recomputes exactly those windows from the same 2-bit-packed
// buffer and returns their limb sums (mod 2^32) so the caller can subtract
// them from the device's unmasked sums — O(rows*k) host work fully
// overlapped with the device pass, instead of an O(n_positions) validity
// cumsum on device.

static void kmer_corr_range(const uint8_t* packed, long nbytes,
                            const int64_t* ends, const int64_t* starts,
                            long row_lo, long row_hi, int k,
                            uint32_t* lo_out, uint32_t* hi_out) {
    const uint64_t mask = (2 * k >= 64) ? ~0ull : ((1ull << (2 * k)) - 1);
    uint32_t lo = 0, hi = 0;
    for (long r = row_lo; r < row_hi; ++r) {
        int64_t e = ends[r];
        int64_t j0 = e - (k - 1);
        if (j0 < starts[r]) j0 = starts[r];
        for (int64_t j = j0; j < e; ++j) {
            long byte = (long)(j >> 2);
            int sh = (int)(j & 3) * 2;
            uint64_t w0 = 0, w1 = 0;
            if (byte + 16 <= nbytes) {
                std::memcpy(&w0, packed + byte, 8);
                std::memcpy(&w1, packed + byte + 8, 8);
            } else {  // zero-padded tail read
                uint8_t buf[16] = {0};
                long avail = nbytes - byte;
                if (avail > 16) avail = 16;
                if (avail > 0) std::memcpy(buf, packed + byte, (size_t)avail);
                std::memcpy(&w0, buf, 8);
                std::memcpy(&w1, buf + 8, 8);
            }
            uint64_t val = (w0 >> sh) | (sh ? (w1 << (64 - sh)) : 0);
            val &= mask;
            lo += (uint32_t)val;
            hi += (uint32_t)(val >> 32);
        }
    }
    *lo_out = lo;
    *hi_out = hi;
}

// out[0] += sum of lo limbs, out[1] += sum of hi limbs (mod 2^32) of all
// row-crossing windows.  packed: 2-bit codes, 4/byte little-endian.
void kmer_correction_sums(const uint8_t* packed, long nbytes,
                          const int64_t* ends, const int64_t* starts,
                          long n_rows, int k, int n_threads,
                          uint32_t* out) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n_rows < (1L << 12)) {
        kmer_corr_range(packed, nbytes, ends, starts, 0, n_rows, k,
                        out, out + 1);
        return;
    }
    std::vector<uint32_t> lo(n_threads), hi(n_threads);
    std::vector<std::thread> workers;
    long per = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        long a = t * per;
        long b = a + per < n_rows ? a + per : n_rows;
        if (a >= b) { lo[t] = hi[t] = 0; continue; }
        workers.emplace_back(kmer_corr_range, packed, nbytes, ends, starts,
                             a, b, k, &lo[t], &hi[t]);
    }
    for (auto& w : workers) w.join();
    uint32_t l = 0, h = 0;
    for (int t = 0; t < n_threads; ++t) { l += lo[t]; h += hi[t]; }
    out[0] = l;
    out[1] = h;
}

// ---- fused FASTQ parse + encode + 2-bit pack ------------------------------
//
// The reference's ingest path is: newline scan -> field gather -> encode LUT
// (bionumpy/io/one_line_buffer.py:36-71 + encoded_array encode) as separate
// numpy passes.  For the device pipeline all we need from a FASTQ chunk is
// the 2-bit-packed sequence stream + per-entry lengths, so this kernel does
// the whole thing in one multithreaded pass over the raw bytes:
//   phase 1 (parallel): newline positions via memchr
//   phase 2 (serial, O(entries)): entry structure validation ('@'/'+'),
//            sequence spans, lengths, base offsets
//   phase 3 (parallel): encode+pack each thread's base range; boundary
//            bytes (shared between threads at 2-bit granularity) are
//            returned as fixups and OR-ed serially.

struct SeqSpan { long start; long len; int64_t base_off; };

static void scan_newlines(const uint8_t* raw, long lo, long hi,
                          std::vector<long>* out) {
    const uint8_t* p = raw + lo;
    const uint8_t* end = raw + hi;
    while (p < end) {
        const uint8_t* nl = (const uint8_t*)std::memchr(p, '\n', end - p);
        if (!nl) break;
        out->push_back(nl - raw);
        p = nl + 1;
    }
}

// Encode+pack bases of entries' sequence spans covering the base range
// [b_lo, b_hi).  Writes only bytes fully inside [b_lo, b_hi); partial
// boundary bytes are accumulated into first_fix/last_fix (to be OR-ed by
// the caller).  enc: 256-entry code table, 255 = invalid.
// err_pos: set to the raw-buffer position of the first invalid byte.
static void pack_entries_range(const uint8_t* raw, const SeqSpan* spans,
                               long e_lo, long e_hi, int64_t b_lo,
                               int64_t b_hi, const uint8_t* enc,
                               uint8_t* out, uint8_t* first_fix,
                               uint8_t* last_fix, long* err_pos) {
    *err_pos = -1;
    uint8_t acc = 0;
    for (long e = e_lo; e < e_hi; ++e) {
        const uint8_t* s = raw + spans[e].start;
        int64_t base = spans[e].base_off;
        for (long j = 0; j < spans[e].len; ++j) {
            uint8_t code = enc[s[j]];
            if (code == 255) {
                if (*err_pos < 0) *err_pos = spans[e].start + j;
                code = 0;
            }
            int64_t pos = base + j;
            acc |= (uint8_t)(code << (2 * (pos & 3)));
            if ((pos & 3) == 3) {
                int64_t byte = pos >> 2;
                // byte is fully owned iff all 4 positions are in range
                if (pos - 3 >= b_lo && pos < b_hi) out[byte] = acc;
                else if (pos - 3 < b_lo) *first_fix = acc;
                acc = 0;
            }
        }
    }
    if (b_hi & 3) *last_fix = acc;  // trailing partial byte of the range
}

// Parse a FASTQ chunk that ends on an entry boundary.
//   raw, n:        chunk bytes
//   out,out_bytes: packed 2-bit output (zero-filled past the data)
//   lengths_out:   per-entry sequence lengths (capacity max_entries)
//   n_threads:     parallelism for scan + pack
//   n_bases_out:   total sequence bases written
// Returns the entry count, or -(pos+1) on a malformed byte at `pos`
// (structure or encoding error).
long fastq_parse_pack(const uint8_t* raw, long n, uint8_t* out,
                      long out_bytes, int32_t* lengths_out,
                      long max_entries, int n_threads,
                      int64_t* n_bases_out) {
    if (n_threads < 1) n_threads = 1;
    if (n < (1L << 16)) n_threads = 1;
    // phase 1: newline positions
    std::vector<std::vector<long>> nl_parts((size_t)n_threads);
    if (n_threads == 1) {
        nl_parts[0].reserve((size_t)(n / 64 + 4));
        scan_newlines(raw, 0, n, &nl_parts[0]);
    } else {
        std::vector<std::thread> ws;
        long per = (n + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            long lo = t * per, hi = lo + per < n ? lo + per : n;
            if (lo >= hi) continue;
            nl_parts[t].reserve((size_t)((hi - lo) / 64 + 4));
            ws.emplace_back(scan_newlines, raw, lo, hi, &nl_parts[t]);
        }
        for (auto& w : ws) w.join();
    }
    std::vector<long> nl;
    {
        size_t total = 0;
        for (auto& p : nl_parts) total += p.size();
        nl.reserve(total);
        for (auto& p : nl_parts) nl.insert(nl.end(), p.begin(), p.end());
    }
    long n_lines = (long)nl.size();
    if (n_lines % 4 != 0) return -(n + 1);
    long n_entries = n_lines / 4;
    if (n_entries > max_entries) return -(n + 1);
    // phase 2: entry structure + spans
    std::vector<SeqSpan> spans((size_t)n_entries);
    int64_t base_off = 0;
    for (long e = 0; e < n_entries; ++e) {
        long h_start = e == 0 ? 0 : nl[4 * e - 1] + 1;
        if (raw[h_start] != '@') return -(h_start + 1);
        long p_start = nl[4 * e + 1] + 1;
        if (raw[p_start] != '+') return -(p_start + 1);
        long s_start = nl[4 * e] + 1;
        long s_len = nl[4 * e + 1] - s_start;
        long q_len = nl[4 * e + 3] - (nl[4 * e + 2] + 1);
        if (q_len != s_len) return -(nl[4 * e + 2] + 2);
        spans[e].start = s_start;
        spans[e].len = s_len;
        spans[e].base_off = base_off;
        lengths_out[e] = (int32_t)s_len;
        base_off += s_len;
    }
    *n_bases_out = base_off;
    if ((base_off + 3) / 4 > out_bytes) return -(n + 1);
    // encode table: ACGT + acgt
    uint8_t enc[256];
    std::memset(enc, 255, 256);
    enc['A'] = enc['a'] = 0;
    enc['C'] = enc['c'] = 1;
    enc['G'] = enc['g'] = 2;
    enc['T'] = enc['t'] = 3;
    // phase 3: pack, partitioned on base offsets
    long used_bytes = (long)((base_off + 3) / 4);
    std::memset(out, 0, (size_t)out_bytes);
    long err = -1;
    if (n_threads == 1 || n_entries < 64) {
        uint8_t f0 = 0, f1 = 0;
        pack_entries_range(raw, spans.data(), 0, n_entries, 0, base_off,
                           enc, out, &f0, &f1, &err);
        if (base_off & 3) out[base_off >> 2] |= f1;
    } else {
        std::vector<std::thread> ws;
        std::vector<uint8_t> firsts((size_t)n_threads, 0),
            lasts((size_t)n_threads, 0);
        std::vector<long> errs((size_t)n_threads, -1);
        std::vector<long> e_bounds((size_t)n_threads + 1, n_entries);
        std::vector<int64_t> b_bounds((size_t)n_threads + 1, base_off);
        e_bounds[0] = 0;
        b_bounds[0] = 0;
        // split entries so each thread gets ~equal bases
        long e = 0;
        for (int t = 1; t < n_threads; ++t) {
            int64_t target = base_off * t / n_threads;
            while (e < n_entries && spans[e].base_off < target) ++e;
            e_bounds[t] = e;
            b_bounds[t] = e < n_entries ? spans[e].base_off : base_off;
        }
        for (int t = 0; t < n_threads; ++t) {
            if (e_bounds[t] >= e_bounds[t + 1]) continue;
            ws.emplace_back(pack_entries_range, raw, spans.data(),
                            e_bounds[t], e_bounds[t + 1], b_bounds[t],
                            b_bounds[t + 1], enc, out, &firsts[t],
                            &lasts[t], &errs[t]);
        }
        for (auto& w : ws) w.join();
        for (int t = 0; t < n_threads; ++t) {
            if (errs[t] >= 0 && (err < 0 || errs[t] < err)) err = errs[t];
            // thread t's boundary bytes: first partial byte at
            // b_bounds[t]>>2, trailing partial byte at b_bounds[t+1]>>2
            if (b_bounds[t] & 3) out[b_bounds[t] >> 2] |= firsts[t];
            if ((b_bounds[t + 1] & 3) && b_bounds[t + 1] < base_off)
                out[b_bounds[t + 1] >> 2] |= lasts[t];
            else if ((b_bounds[t + 1] & 3) && b_bounds[t + 1] == base_off)
                out[b_bounds[t + 1] >> 2] |= lasts[t];
        }
    }
    (void)used_bytes;
    if (err >= 0) return -(err + 1);
    return n_entries;
}

// Append a 2-bit-packed code stream (from base 0 of `src`) into `dst`
// at base offset `dst_base_off` (2 bits per base, little-endian within
// each byte).  Bytes of dst BEYOND the first touched byte are
// overwritten, so streams must be appended left to right; the first
// byte is merge-OR'd with existing content.  Used by the fused
// member-parse ingest to stitch per-member packed sequences into one
// batch buffer while touching only packed (0.25 B/base) data.
void copy_2bit_shifted(const uint8_t* src, long n_bases, uint8_t* dst,
                       long dst_base_off) {
    if (n_bases <= 0) return;
    long n_src_bytes = (n_bases + 3) >> 2;
    uint8_t* d = dst + (dst_base_off >> 2);
    int sh = (int)(dst_base_off & 3) * 2;
    if (sh == 0) {
        std::memcpy(d, src, (size_t)n_src_bytes);
        return;
    }
    uint8_t keep = (uint8_t)(d[0] & ((1u << sh) - 1));
    long i = 0;
    uint64_t prev = 0;
    // 8-byte blocks: out = (in << sh) | (carry bits from the previous
    // block's top byte)
    for (; i + 8 <= n_src_bytes; i += 8) {
        uint64_t w;
        std::memcpy(&w, src + i, 8);
        uint64_t out = (w << sh) | prev;
        std::memcpy(d + i, &out, 8);
        prev = w >> (64 - sh);
    }
    uint8_t carry = (uint8_t)prev;
    for (; i < n_src_bytes; ++i) {
        d[i] = (uint8_t)((src[i] << sh) | carry);
        carry = (uint8_t)(src[i] >> (8 - sh));
    }
    d[n_src_bytes] = carry;  // spill of the final byte's top bits
    d[0] = (uint8_t)(d[0] | keep);
}

// Gather per-row byte slices [starts[r], starts[r]+lens[r]) from src
// into a packed flat output — ONE pass at memcpy speed instead of the
// ~6 int64 index-building passes (48 B of traffic per gathered byte)
// of numpy's fancy-gather plan.
// This is the hot path of every delimited-format field extraction
// (VCF/BED/GTF columns).  Returns total bytes written, or -1 if any
// row is out of bounds (caller falls back to the checked numpy path).
// `out` must have >= 7 bytes of slack past the packed total (the
// short-row fast path stores a full 8-byte word).
long gather_rows_u8(const uint8_t* src, long src_n,
                    const int64_t* starts, const int64_t* lens,
                    long n_rows, uint8_t* out) {
    long o = 0;
    for (long r = 0; r < n_rows; ++r) {
        long s = starts[r], l = lens[r];
        if (l < 0 || s < 0 || s + l > src_n) return -1;
        if (l == 1) {
            out[o++] = src[s];
        } else if (l <= 8 && s + 8 <= src_n) {
            uint64_t w;
            std::memcpy(&w, src + s, 8);
            std::memcpy(out + o, &w, 8);  // over-write ok: packed next
            o += l;
        } else {
            std::memcpy(out + o, src + s, (size_t)l);
            o += l;
        }
    }
    return o;
}

// Parse signed decimal rows [starts[r], ends[r]) of src into int64 —
// one pass, no padded digit-matrix intermediate (the numpy plan builds
// a (n, width) int64 index matrix + gather + mask scatter).  Returns 0
// on success or
// -1 on ANY anomaly (empty row, non-digit, >18 digits, out of
// bounds); the caller then falls back to the checked numpy path,
// which produces the proper FormatException with offsets.
long parse_ints(const uint8_t* src, long src_n, const int64_t* starts,
                const int64_t* ends, long n, int64_t* out) {
    for (long r = 0; r < n; ++r) {
        long s = starts[r], e = ends[r];
        if (s < 0 || e > src_n || e <= s) return -1;
        int neg = 0;
        if (src[s] == '-') { neg = 1; ++s; }
        else if (src[s] == '+') { ++s; }
        if (e <= s || e - s > 18) return -1;
        long v = 0;
        for (long i = s; i < e; ++i) {
            unsigned d = (unsigned)src[i] - '0';
            if (d > 9) return -1;
            v = v * 10 + (long)d;
        }
        out[r] = neg ? -v : v;
    }
    return 0;
}

}  // extern "C"
