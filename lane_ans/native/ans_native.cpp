// Native host backend: exact model math + compat-format rANS engine.
//
// C++ re-implementation of the hot host-side paths of the golden model
// (lane_ans/reference_model), NOT a copy of the reference C++ — the
// semantics are specified by model.py / rans_compat.py, which in turn
// document their reference provenance (include/ans_util.hpp,
// include/ans_int.hpp stream discipline).  Floating-point evaluation
// order matches model.py exactly so frames — and therefore bytes — are
// identical across the Python and native paths.
//
// Build: python -m lane_ans.native.build   (g++ -O3 -shared -fPIC)
// ABI: plain C functions over raw pointers; ctypes binding in binding.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- model ---

double ans_entropy_ordered(const uint64_t* freqs, int64_t n,
                           uint64_t freq_sum) {
    double h = 0.0;
    double dn = (double)freq_sum;
    for (int64_t i = 0; i < n; i++) {
        if (freqs[i]) {
            double p = (double)freqs[i] / dn;
            h += p * std::log2(p);
        }
    }
    return -h;
}

double ans_cross_entropy_ordered(const uint64_t* P, int64_t np_,
                                 const uint32_t* Q, int64_t nq) {
    double n = 0.0, m = 0.0;
    {
        uint64_t ns = 0, ms = 0;
        for (int64_t i = 0; i < np_; i++) ns += P[i];
        for (int64_t i = 0; i < nq; i++) ms += Q[i];
        n = (double)ns;
        m = (double)ms;
    }
    int64_t k = np_ < nq ? np_ : nq;
    double h = 0.0;
    for (int64_t i = 0; i < k; i++) {
        if (P[i] != 0 && Q[i] != 0)
            h += ((double)P[i] / n) * std::log2((double)Q[i] / m);
    }
    return -h;
}

// One proportional rescale pass; returns 1 when M underflows (retry
// with a larger frame).  Mutates S.  (model.py scale_freqs semantics.)
int32_t ans_scale_freqs(uint32_t* S, const uint64_t* F,
                        const int64_t* mapping, int64_t M, int64_t sigma,
                        int64_t freq_sum) {
    for (int64_t cur = 0; cur < sigma; cur++) {
        int64_t msym = mapping[cur];
        int64_t f = (int64_t)F[msym];
        double aratio = (double)M / (double)freq_sum;
        uint32_t s = (uint32_t)(0.5 + aratio * (double)f);
        if (s == 0) s = 1;
        S[msym] = s;
        M -= s;
        freq_sum -= f;
        if (M < 0) break;
    }
    return M != 0;
}

// ------------------------------------------------- compat rANS streams ---
// 4 interleaved u64 states, shared byte stream, reverse-order encode
// (spec: rans_compat.py interleaved_encode/decode).

static const int NUM_STATES = 4;

int64_t ans_compat_encode(const uint32_t* mapped, int64_t n,
                          const uint8_t* exc_counts,   // may be null
                          const uint8_t* exc_bytes,    // (n,3) or null
                          const uint32_t* freq, const uint32_t* base,
                          int64_t M, uint8_t* out, int64_t cap) {
    uint64_t L = 16ull * (uint64_t)M;
    uint64_t states[NUM_STATES] = {L, L, L, L};
    int64_t r = n % NUM_STATES;
    int64_t pos = 0;
    for (int64_t j = 0; j < n; j++) {
        int64_t p = n - 1 - j;
        int sidx = (j < r) ? 0 : (int)((j - r) % NUM_STATES);
        if (exc_counts) {
            int k = exc_counts[p];
            for (int i = 0; i < k; i++) out[pos++] = exc_bytes[p * 3 + i];
        }
        uint32_t s = mapped[p];
        uint64_t f = freq[s];
        uint64_t st = states[sidx];
        uint64_t sub = (16ull << 32) * f;
        if (st >= sub) {
            out[pos] = (uint8_t)st;
            out[pos + 1] = (uint8_t)(st >> 8);
            out[pos + 2] = (uint8_t)(st >> 16);
            out[pos + 3] = (uint8_t)(st >> 24);
            pos += 4;
            st >>= 32;
        }
        states[sidx] = (st / f) * (uint64_t)M + (st % f) + base[s];
        if (pos + 64 > cap) return -1;
    }
    for (int i = 0; i < NUM_STATES; i++) {
        uint64_t v = states[i] - L;
        for (int b = 0; b < 8; b++) out[pos++] = (uint8_t)(v >> (8 * b));
    }
    return pos;
}

// Decode n symbols; slot tables are (M,) arrays.  high/nb may be null
// (identity coders).  Returns bytes consumed from the END of buf
// (diagnostic), or -1 on underrun.
int64_t ans_compat_decode(const uint8_t* buf, int64_t len, int64_t n,
                          const uint32_t* freq_slot,
                          const uint32_t* offset_slot,
                          const uint32_t* sym_slot, int64_t M,
                          const uint32_t* high, const uint8_t* nb,
                          uint32_t* out) {
    // corrupt wire data must fail, not index a 2^64-1 mask into the
    // slot tables: M comes from a decoded prelude
    if (M <= 0 || (M & (M - 1)) != 0) return -1;
    uint64_t L = 16ull * (uint64_t)M;
    uint64_t mask = (uint64_t)M - 1;
    int log2m = 0;
    while ((1ll << log2m) < M) log2m++;
    int64_t cur = len;
    uint64_t states[NUM_STATES];
    for (int i = 0; i < NUM_STATES; i++) {
        cur -= 8;
        if (cur < 0) return -1;
        uint64_t v = 0;
        for (int b = 7; b >= 0; b--) v = (v << 8) | buf[cur + b];
        states[i] = v + L;
    }
    int64_t fast = n - (n % NUM_STATES);
    for (int64_t i = 0; i < n; i++) {
        int sidx = (i < fast) ? (int)(i % NUM_STATES) : NUM_STATES - 1;
        uint64_t st = states[sidx];
        uint64_t slot = st & mask;
        st = (uint64_t)freq_slot[slot] * (st >> log2m) + offset_slot[slot];
        if (st < L) {
            cur -= 4;
            if (cur < 0) return -1;
            uint32_t w = (uint32_t)buf[cur] | ((uint32_t)buf[cur + 1] << 8)
                | ((uint32_t)buf[cur + 2] << 16)
                | ((uint32_t)buf[cur + 3] << 24);
            st = (st << 32) | w;
        }
        states[sidx] = st;
        uint32_t sym = sym_slot[slot];
        if (high) {
            int k = nb[slot];
            uint32_t low = 0;
            if (k) {
                cur -= k;
                if (cur < 0) return -1;
                for (int b = k - 1; b >= 0; b--)
                    low = (low << 8) | buf[cur + b];
            }
            out[i] = high[slot] + low;
        } else {
            out[i] = sym;
        }
    }
    return len - cur;
}

// ------------------------------------------------------------------ mtf ---

void ans_mtf(const uint32_t* seq, int64_t n, int64_t sigma,
             uint32_t* out) {
    // table[i] = symbol at rank i; pos[sym] = rank
    uint32_t* table = new uint32_t[sigma];
    uint32_t* posa = new uint32_t[sigma];
    for (int64_t i = 0; i < sigma; i++) {
        table[i] = (uint32_t)i;
        posa[i] = (uint32_t)i;
    }
    for (int64_t i = 0; i < n; i++) {
        uint32_t v = seq[i];
        uint32_t r = posa[v];
        out[i] = r;
        for (uint32_t j = r; j > 0; j--) {
            table[j] = table[j - 1];
            posa[table[j]] = j;
        }
        table[0] = v;
        posa[v] = 0;
    }
    delete[] table;
    delete[] posa;
}

// ---------------------------------------------------------------- shuff ---
// Canonical-Huffman payload pack/unpack (hot loops of models/shuff.py;
// reference counterpart: shuff.hpp:788-894 — re-designed around an
// MSB-first byte stream + 16-bit LUT, not a translation).

// Pack n codewords MSB-first: codes/lens indexed by the dense symbol
// ids.  Returns bytes written, or -1 on overflow / length > 32.
int64_t shuff_pack(const uint32_t* ids, int64_t n, const uint32_t* codes,
                   const uint8_t* lens, uint8_t* out, int64_t cap) {
    uint64_t acc = 0;
    int nbits = 0;
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t id = ids[i];
        int l = lens[id];
        if (l == 0 || l > 32) return -1;
        acc |= (uint64_t)codes[id] << (64 - nbits - l);
        nbits += l;
        while (nbits >= 8) {
            if (pos >= cap) return -1;
            out[pos++] = (uint8_t)(acc >> 56);
            acc <<= 8;
            nbits -= 8;
        }
    }
    if (nbits) {
        if (pos >= cap) return -1;
        out[pos++] = (uint8_t)(acc >> 56);
    }
    return pos;
}

// Unpack n symbols from an MSB-first bit stream.  lut16[w] = code length
// for 16-bit prefix w (0 = longer than 16 bits: scan lengths 17..max).
// first_code/first_idx are canonical per-length tables (len max_len+2),
// syms is sorted by (len, code).  Returns bits consumed or -1.
int64_t shuff_unpack(const uint8_t* in, int64_t nbytes, int64_t n,
                     const uint8_t* lut16, const int64_t* first_code,
                     const int64_t* first_idx, int64_t max_len,
                     const uint32_t* syms, uint32_t* out) {
    uint64_t acc = 0;
    int nbits = 0;
    int64_t pos = 0;
    int64_t used = 0;
    if (max_len < 1 || max_len > 64) return -1;  // shift below needs l<=64
    for (int64_t i = 0; i < n; i++) {
        // branchless refill to >= 57 valid bits: one unaligned
        // big-endian load (the binding pads the buffer with 8 zero
        // bytes) + a clamped advance so truncation accounting holds.
        // The old per-byte while loop iterated ~bpi/8 times per symbol
        // with a data-dependent branch.
        uint64_t w;
        memcpy(&w, in + pos, 8);
        w = __builtin_bswap64(w);
        acc |= nbits < 64 ? (w >> nbits) : 0;
        int64_t adv = (63 - nbits) >> 3;
        int64_t rem = nbytes - pos;
        if (adv > rem) adv = rem;
        pos += adv;
        nbits += (int)(adv << 3);
        int l = lut16[acc >> 48];
        if (l > 16) {
            // lut value = minimal length of any code with this 16-bit
            // prefix; scan up from there (prefix-freeness makes the
            // first canonical-range match the true length)
            for (; l <= (int)max_len; l++) {
                int64_t pfx = (int64_t)(acc >> (64 - l));
                int64_t j = pfx - first_code[l];
                if (j >= 0 && first_idx[l] + j < first_idx[l + 1]) break;
            }
            if (l > (int)max_len) return -1;
        } else if (l == 0) {
            return -1;  // no codeword has this prefix: corrupt
        }
        // truncated payload: the zero-refilled accumulator would keep
        // "matching" the shortest codeword forever — fail instead
        if (nbits < l) return -1;
        int64_t pfx = (int64_t)(acc >> (64 - l));
        int64_t k = first_idx[l] + (pfx - first_code[l]);
        out[i] = syms[k];
        acc <<= l;
        nbits -= l;
        used += l;
    }
    return used;
}

// 4-interleaved-substream pack: symbols at positions i with i mod 4 ==
// j go to stream j, each an independent MSB-first byte sequence
// written at out + j*cap4.  The single-stream pack is serial on its
// accumulator (~10 ns/sym at 16-bit codes); four chains with
// distance-4 dependencies run out-of-order in parallel, like the
// reference's 4 interleaved ANS states (ans_int.hpp:225-241) applied
// to Huffman.  The flush is branchless: store the full 8-byte
// accumulator big-endian every symbol and advance by the completed
// bytes (nbits stays < 8 + 32 < 64).  Returns 0 with the stream byte
// lengths in len4[4], or -1 on overflow / length outside [1, 32].
int64_t shuff_pack4(const uint32_t* ids, int64_t n, const uint32_t* codes,
                    const uint8_t* lens, int64_t max_len, uint8_t* out,
                    int64_t cap4, int64_t* len4) {
    uint64_t acc[4] = {0, 0, 0, 0};
    int nbits[4] = {0, 0, 0, 0};
    int64_t pos[4];
    for (int64_t j = 0; j < 4; j++) pos[j] = j * cap4;
    int64_t i = 0;
    if (max_len >= 1 && max_len <= 28) {
        // two codes always fit one flush (7 + 2*28 < 64): insert a
        // pair per chain per 8-group and halve the stores + loop
        // skeleton; the emitted bytes are identical to the one-symbol
        // path (same MSB-first stream, same byte boundaries)
        for (; i + 8 <= n; i += 8) {
            for (int j = 0; j < 4; j++) {
                uint32_t a = ids[i + j], b = ids[i + 4 + j];
                int la = lens[a], lb = lens[b];
                if (la == 0 || lb == 0) return -1;
                uint64_t v = ((uint64_t)codes[a] << (64 - la))
                    | ((uint64_t)codes[b] << (64 - la - lb));
                acc[j] |= v >> nbits[j];
                nbits[j] += la + lb;
                if (pos[j] + 8 > (j + 1) * cap4) return -1;
                uint64_t be = __builtin_bswap64(acc[j]);
                memcpy(out + pos[j], &be, 8);
                int adv = nbits[j] >> 3;
                pos[j] += adv;
                acc[j] <<= adv << 3;
                nbits[j] &= 7;
            }
        }
    }
    for (; i < n; i++) {
        int j = (int)(i & 3);
        uint32_t id = ids[i];
        int l = lens[id];
        if (l == 0 || l > 32) return -1;
        acc[j] |= (uint64_t)codes[id] << (64 - nbits[j] - l);
        nbits[j] += l;
        if (pos[j] + 8 > (j + 1) * cap4) return -1;
        uint64_t be = __builtin_bswap64(acc[j]);
        memcpy(out + pos[j], &be, 8);
        int adv = nbits[j] >> 3;
        pos[j] += adv;
        acc[j] <<= adv << 3;
        nbits[j] &= 7;
    }
    for (int j = 0; j < 4; j++) {
        if (nbits[j]) {
            // the byte is already in place from the last 8-byte store;
            // just include it in the stream length
            pos[j]++;
        }
        len4[j] = pos[j] - j * cap4;
    }
    return 0;
}

// 4-substream unpack: chain j decodes out[j], out[j+4], ... from its
// own byte range [off[j], off[j]+slen[j]) of the shared buffer.
// Mirrors shuff_unpack, but four refill/LUT/canonical chains run in a
// 4-wide unrolled loop with NAMED per-chain registers (an index-j
// state array spills to the stack and costs more than the overlap
// wins), so their L2-resident lut16/syms gathers and serial shift
// chains overlap.  The caller pads the buffer tail by 8 zero bytes; a
// chain's unaligned refill may read the NEXT stream's bytes, which
// only ever lands in accumulator bits at positions >= the chain's
// accounted nbits (the clamped advance stops at the stream end, and
// `acc <<= l` moves the boundary and the bits together), so
// well-formed wires decode exactly and corrupt ones stay
// garbage-or-error with every table index in range.
int64_t shuff_unpack4(const uint8_t* in, const int64_t* off,
                      const int64_t* slen, int64_t n,
                      const uint8_t* lut16, const int64_t* first_code,
                      const int64_t* first_idx, int64_t max_len,
                      const uint32_t* syms, uint32_t* out) {
    if (max_len < 1 || max_len > 64) return -1;
    // fold the two per-length tables into one offset (sym index =
    // offs[l] + prefix) so the hot path loads once per table, and
    // precompute lim1[l] = the LAST left-justified accumulator value
    // that decodes at length l: lim1[l] = ((first_code[l] + cnt[l])
    // << (64-l)) - 1, computed in 128-bit so the complete-code top
    // (2^64) saturates to UINT64_MAX.  Canonical codes tile the
    // left-justified space contiguously (first_code[l+1] =
    // (first_code[l]+cnt[l]) << 1), so lim1 is monotone and
    // "length of acc" = first l with acc <= lim1[l] — the long-code
    // scan becomes one load + compare per step instead of the old
    // shift + subtract + two-load range test, and any acc <= the
    // final lim1 yields an in-range syms index even on garbage input
    // (acc beyond it is the incomplete-code gap: return -1).
    // max_len <= 64 keeps these on the stack.
    int64_t offs[67];
    uint64_t lim1[67];
    for (int64_t l = 0; l < 67; l++) { offs[l] = 0; lim1[l] = ~0ULL; }
    for (int64_t l = 0; l <= max_len; l++) {
        offs[l] = first_idx[l] - first_code[l];
        unsigned __int128 end =
            (unsigned __int128)(first_code[l] + first_idx[l + 1]
                                - first_idx[l]) << (64 - l);
        lim1[l] = end ? (uint64_t)(end - 1) : 0;
        if (end >> 64) lim1[l] = ~0ULL;
    }
    uint64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    int b0 = 0, b1 = 0, b2 = 0, b3 = 0;
    int64_t p0 = off[0], p1 = off[1], p2 = off[2], p3 = off[3];
    int64_t e0 = p0 + slen[0], e1 = p1 + slen[1];
    int64_t e2 = p2 + slen[2], e3 = p3 + slen[3];

#define SHUF4_REFILL(acc, nbits, pos, end)                                 \
    do {                                                                   \
        uint64_t w;                                                        \
        memcpy(&w, in + (pos), 8);                                         \
        w = __builtin_bswap64(w);                                          \
        (acc) |= (nbits) < 64 ? (w >> (nbits)) : 0;                        \
        int64_t adv = (63 - (nbits)) >> 3;                                 \
        int64_t rem = (end) - (pos);                                       \
        if (adv > rem) adv = rem;                                          \
        (pos) += adv;                                                      \
        (nbits) += (int)(adv << 3);                                        \
    } while (0)

// long codes: lut16 gives the minimal length of any code with this
// 16-bit prefix; two branchless lim1 steps absorb the common 1-2
// length spread (uniform-ish alphabets alternate l/l+1 every symbol,
// which as a loop branch mispredicts ~once per symbol), then the loop
// mops up heavy-tailed length sets.  l never exceeds max_len+1
// (lim1 past max_len is all-ones), and the two branchless steps stay
// inside lim1[67] since the lut start is <= max_len <= 64.
#define SHUF4_DECODE(acc, nbits, dst)                                      \
    do {                                                                   \
        int l = lut16[(acc) >> 48];                                        \
        if (l > 16) {                                                      \
            l += (acc) > lim1[l];                                          \
            l += (acc) > lim1[l];                                          \
            while ((acc) > lim1[l]) l++;                                   \
            if (l > (int)max_len) return -1; /* incomplete-code gap */     \
        } else if (l == 0) {                                               \
            return -1; /* no codeword has this prefix */                   \
        }                                                                  \
        if ((nbits) < l) return -1;                                        \
        int64_t pfx = (int64_t)((acc) >> (64 - l));                        \
        (dst) = syms[offs[l] + pfx];                                       \
        (acc) <<= l;                                                       \
        (nbits) -= l;                                                      \
    } while (0)

    int64_t i = 0;
    // one refill holds >= 57 valid bits, so k = floor(57 / max_len)
    // symbols decode per chain between refills; the k = 2 / k = 3
    // blocks halve / third the refill work AND widen the window the
    // out-of-order core can overlap syms gathers across (measured
    // +11..40% on the standard datasets, tools/bench_host_coders.py)
    if (3 * max_len <= 57) {
        int64_t n12 = n - (n % 12);
        for (; i < n12; i += 12) {
            SHUF4_REFILL(a0, b0, p0, e0);
            SHUF4_REFILL(a1, b1, p1, e1);
            SHUF4_REFILL(a2, b2, p2, e2);
            SHUF4_REFILL(a3, b3, p3, e3);
            SHUF4_DECODE(a0, b0, out[i]);
            SHUF4_DECODE(a1, b1, out[i + 1]);
            SHUF4_DECODE(a2, b2, out[i + 2]);
            SHUF4_DECODE(a3, b3, out[i + 3]);
            SHUF4_DECODE(a0, b0, out[i + 4]);
            SHUF4_DECODE(a1, b1, out[i + 5]);
            SHUF4_DECODE(a2, b2, out[i + 6]);
            SHUF4_DECODE(a3, b3, out[i + 7]);
            SHUF4_DECODE(a0, b0, out[i + 8]);
            SHUF4_DECODE(a1, b1, out[i + 9]);
            SHUF4_DECODE(a2, b2, out[i + 10]);
            SHUF4_DECODE(a3, b3, out[i + 11]);
        }
    } else if (2 * max_len <= 57) {
        int64_t n8 = n & ~(int64_t)7;
        for (; i < n8; i += 8) {
            SHUF4_REFILL(a0, b0, p0, e0);
            SHUF4_REFILL(a1, b1, p1, e1);
            SHUF4_REFILL(a2, b2, p2, e2);
            SHUF4_REFILL(a3, b3, p3, e3);
            SHUF4_DECODE(a0, b0, out[i]);
            SHUF4_DECODE(a1, b1, out[i + 1]);
            SHUF4_DECODE(a2, b2, out[i + 2]);
            SHUF4_DECODE(a3, b3, out[i + 3]);
            SHUF4_DECODE(a0, b0, out[i + 4]);
            SHUF4_DECODE(a1, b1, out[i + 5]);
            SHUF4_DECODE(a2, b2, out[i + 6]);
            SHUF4_DECODE(a3, b3, out[i + 7]);
        }
    }
    int64_t n4 = n & ~(int64_t)3;
    for (; i < n4; i += 4) {
        SHUF4_REFILL(a0, b0, p0, e0);
        SHUF4_REFILL(a1, b1, p1, e1);
        SHUF4_REFILL(a2, b2, p2, e2);
        SHUF4_REFILL(a3, b3, p3, e3);
        SHUF4_DECODE(a0, b0, out[i]);
        SHUF4_DECODE(a1, b1, out[i + 1]);
        SHUF4_DECODE(a2, b2, out[i + 2]);
        SHUF4_DECODE(a3, b3, out[i + 3]);
    }
    if (i < n) { SHUF4_REFILL(a0, b0, p0, e0); SHUF4_DECODE(a0, b0, out[i]); i++; }
    if (i < n) { SHUF4_REFILL(a1, b1, p1, e1); SHUF4_DECODE(a1, b1, out[i]); i++; }
    if (i < n) { SHUF4_REFILL(a2, b2, p2, e2); SHUF4_DECODE(a2, b2, out[i]); i++; }
#undef SHUF4_REFILL
#undef SHUF4_DECODE
    return 0;
}

// ----------------------------------------------------------------- tANS ---
// Tabled-ANS hot loops (spec: models/tans.py — 4 interleaved states
// over one LSB-first bitstream, encoded in reverse, decoded forward
// reading from the tail).  Tables are built in Python; only the
// per-symbol loops live here.

static const int TANS_STATES = 4;

// Returns total bits written (payload bytes = ceil(bits/8)), final
// states in states_out[4], or -1 on overflow.  sigma = table length
// (<= 256: ids are bytes); per-symbol loads are packed into one u64
// (cutoff | aux<<32 with aux = (delta + L) << 5 | k0, delta =
// cumbase - q).  The bitstream flush is branchless: every iteration
// stores the whole 8-byte accumulator and advances by the completed
// bytes (nb <= 12 keeps fill < 8 + 12 < 64), so the hot loop carries
// no data-dependent branch — the old 4-byte conditional flush
// mispredicted every ~5 symbols and dominated the runtime.
int64_t tans_encode(const uint8_t* ids, int64_t n, const uint8_t* k0,
                    const uint32_t* cutoff, const uint32_t* cumbase,
                    const uint32_t* q, const uint32_t* enc_next,
                    int64_t L, int64_t sigma, uint32_t* states_out,
                    uint8_t* out, int64_t cap) {
    uint64_t stab[256];
    for (int64_t s = 0; s < sigma; s++) {
        uint64_t aux = (((uint64_t)((int64_t)cumbase[s] - (int64_t)q[s]
                                    + L)) << 5) | k0[s];
        stab[s] = (uint64_t)cutoff[s] | (aux << 32);
    }
    uint32_t st[TANS_STATES] = {(uint32_t)L, (uint32_t)L, (uint32_t)L,
                                (uint32_t)L};
    uint64_t acc = 0;
    int fill = 0;
    int64_t pos = 0;
    for (int64_t p = n - 1; p >= 0; p--) {
        uint64_t e = stab[ids[p]];
        uint32_t x = st[p & 3];
        uint32_t aux = (uint32_t)(e >> 32);
        int nb = (int)(aux & 31) - (x < (uint32_t)e);
        acc |= (uint64_t)(x & ((1u << nb) - 1)) << fill;
        fill += nb;
        if (pos + 8 > cap) return -1;
        memcpy(out + pos, &acc, 8);
        int adv = fill >> 3;
        pos += adv;
        acc >>= adv << 3;
        fill &= 7;
        st[p & 3] = enc_next[(int64_t)(aux >> 5) - L + (x >> nb)];
    }
    int64_t total_bits = 8 * pos + fill;
    if (fill > 0) {
        if (pos >= cap) return -1;
        out[pos] = (uint8_t)acc;
    }
    for (int i = 0; i < TANS_STATES; i++) states_out[i] = st[i];
    return total_bits;
}

// Byte histogram (np.bincount replacement for the entropy stages:
// ~30 ms -> ~2 ms on 8 MB).  Four sub-tables break the increment
// dependency chain on repeated symbols.
void hist_u8(const uint8_t* data, int64_t n, uint64_t* out256) {
    uint64_t h[4][256] = {};
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        h[0][data[i]]++;
        h[1][data[i + 1]]++;
        h[2][data[i + 2]]++;
        h[3][data[i + 3]]++;
    }
    for (; i < n; i++) h[0][data[i]]++;
    for (int s = 0; s < 256; s++)
        out256[s] = h[0][s] + h[1][s] + h[2][s] + h[3][s];
}

// u32 value histogram (np.bincount replacement for the model pass of
// the host coders: bincount measured ~19M vals/s on 1M bins, this loop
// is cache-bound at ~150-300M).  Caller zeroes `out` (nbins entries)
// and guarantees every value < nbins.
void hist_u32(const uint32_t* data, int64_t n, uint64_t* out) {
    for (int64_t i = 0; i < n; i++) out[data[i]]++;
}

// gather out[i] = table[idx[i]] (the value -> dense-rank remap of the
// host coders; numpy fancy indexing pays ~1 s on 33M elements)
void remap_u32(const uint32_t* table, const uint32_t* idx, int64_t n,
               uint32_t* out) {
    for (int64_t i = 0; i < n; i++) out[i] = table[idx[i]];
}

// Optimal prefix-code lengths for an ASCENDING-sorted positive
// frequency array: two-queue Huffman merge, O(sigma) — the compiled
// replacement for the Python heap loop that capped shuff encode at
// ~3M ints/s on sigma ~ 10^6 alphabets (reference counterpart:
// shuff.hpp:451-513 Moffat-Katajainen in-place calculation; same
// lengths, different construction).  out_lens per sorted position.
void huff_code_lengths(const uint64_t* f, int64_t sigma,
                       int64_t* out_lens) {
    if (sigma == 1) {
        out_lens[0] = 1;
        return;
    }
    std::vector<int64_t> parent(2 * sigma - 1, -1);
    std::vector<uint64_t> w(sigma - 1);
    int64_t li = 0, qh = 0, next = sigma;
    for (int64_t step = 0; step < sigma - 1; ++step) {
        int64_t a, b;
        uint64_t wa, wb;
        if (li < sigma && (qh >= next - sigma || f[li] <= w[qh])) {
            a = li;
            wa = f[li++];
        } else {
            a = sigma + qh;
            wa = w[qh++];
        }
        if (li < sigma && (qh >= next - sigma || f[li] <= w[qh])) {
            b = li;
            wb = f[li++];
        } else {
            b = sigma + qh;
            wb = w[qh++];
        }
        parent[a] = parent[b] = next;
        w[next - sigma] = wa + wb;
        next++;
    }
    std::vector<int32_t> depth(2 * sigma - 1, 0);
    for (int64_t node = 2 * sigma - 3; node >= 0; --node)
        depth[node] = depth[parent[node]] + 1;
    for (int64_t i = 0; i < sigma; i++) out_lens[i] = depth[i];
}

// payload must be readable for 8 bytes past any bit position (caller
// pads).  states_in = the encoder's final states.  out is the byte
// alphabet directly (sym < 256 — writing u8 saves the caller an
// 8M-element astype; a packed one-u64-per-slot table variant measured
// SLOWER than the three separate L1-resident tables, so keep these).
int64_t tans_decode(const uint8_t* payload, int64_t total_bits,
                    int64_t n, const uint32_t* sym, const uint8_t* nbt,
                    const uint32_t* base, int64_t L,
                    const uint32_t* states_in, uint8_t* out) {
    uint32_t st[TANS_STATES];
    for (int i = 0; i < TANS_STATES; i++) st[i] = states_in[i];
    int64_t cur = total_bits;
    for (int64_t i = 0; i < n; i++) {
        uint32_t x = st[i & 3];
        int64_t p = (int64_t)x - L;
        // corrupt wire data (header states / bit count) must fail, not
        // read out of bounds — the predictable-untaken checks cost ~2%
        if ((uint64_t)p >= (uint64_t)L || cur < nbt[p]) return -1;
        out[i] = (uint8_t)sym[p];
        int nb = nbt[p];
        cur -= nb;
        uint64_t w;
        memcpy(&w, payload + (cur >> 3), 8);
        uint32_t bits = (uint32_t)((w >> (cur & 7))
                                   & ((1u << nb) - 1));
        st[i & 3] = base[p] + bits;
    }
    return 0;
}

// --------------------------------------------------- arith range coder ---
// Compiled twins of the models/arith.py hot loops (64-bit carryless
// range coder, Subbotin scheme).  Bit-exact with the Python fallback:
// all arithmetic is mod 2^64, the model (cum/freq) is built by the
// caller.  Each chain stays inherently sequential (single carry
// chain) — the reference's coder is one such chain (arith.hpp:
// 245-483); this wire splits the input over FOUR independent chains
// (element i mod 4), the same substream discipline as shuff_pack4.

static const uint64_t ARITH_TOP = 1ULL << 56;
static const uint64_t ARITH_BOT = 1ULL << 48;

// 4-interleaved-substream encode: element i rides chain i mod 4, each
// chain an independent carryless range coder writing its own byte
// stream at out + j*cap4 (same substream discipline as shuff_pack4 —
// the single coder is serial on low/rng and on the per-symbol
// vcumfq[x] gather; four named-register chains overlap both).
// vcumfq[x] = cum[x] << 32 | freq[x] indexed directly by the coded
// value (the caller builds it value-indexed, fusing the dense-rank
// remap away); tl2 = log2(model total) <= 31.  Returns 0 with stream
// byte lengths in len4[4], or -1 on overflow.
int64_t arith_encode4(const uint64_t* vcumfq, const uint32_t* xs,
                      int64_t n, uint32_t tl2, uint8_t* out,
                      int64_t cap4, int64_t* len4) {
    uint64_t lo0 = 0, lo1 = 0, lo2 = 0, lo3 = 0;
    uint64_t rg0 = ~0ULL, rg1 = ~0ULL, rg2 = ~0ULL, rg3 = ~0ULL;
    int64_t w0 = 0, w1 = cap4, w2 = 2 * cap4, w3 = 3 * cap4;
    const int64_t m0 = cap4, m1 = 2 * cap4, m2 = 3 * cap4, m3 = 4 * cap4;

// Settled top bytes batch exactly: one emit shifts low/rng left 8, so
// the settle test x = low^(low+rng) just shifts too (x' = x<<8) — the
// byte-at-a-time loop emits exactly clz(x)>>3 bytes before the test
// flips.  One 8-byte store covers them all (b <= 7), removing the
// per-byte branch the original loop mispredicted ~once per symbol.
#define ARITH4_STEP(low, rng, w, lim, x)                                   \
    do {                                                                   \
        uint64_t v = vcumfq[x];                                            \
        uint64_t r = (rng) >> tl2;                                         \
        (low) += r * (v >> 32);                                            \
        (rng) = r * (v & 0xFFFFFFFFULL);                                   \
        for (;;) {                                                         \
            uint64_t xr = (low) ^ ((low) + (rng));                         \
            if (xr < ARITH_TOP) {                                          \
                int b = __builtin_clzll(xr | 1) >> 3; /* in [1,7] */       \
                if ((w) + 8 > (lim)) return -1;                            \
                uint64_t be = __builtin_bswap64(low);                      \
                memcpy(out + (w), &be, 8);                                 \
                (w) += b;                                                  \
                (low) <<= b << 3;                                          \
                (rng) <<= b << 3;                                          \
            } else if ((rng) < ARITH_BOT) {                                \
                /* range underflow: clamp rng to the BOT boundary and  */  \
                /* emit one byte (the un-batched original fell through */  \
                /* to the shared emit here)                            */  \
                (rng) = (0 - (low)) & (ARITH_BOT - 1);                     \
                if ((w) >= (lim)) return -1;                               \
                out[(w)++] = (uint8_t)((low) >> 56);                       \
                (low) <<= 8;                                               \
                (rng) <<= 8;                                               \
            } else {                                                       \
                break;                                                     \
            }                                                              \
        }                                                                  \
    } while (0)

    int64_t i = 0;
    int64_t n4 = n & ~(int64_t)3;
    for (; i < n4; i += 4) {
        ARITH4_STEP(lo0, rg0, w0, m0, xs[i]);
        ARITH4_STEP(lo1, rg1, w1, m1, xs[i + 1]);
        ARITH4_STEP(lo2, rg2, w2, m2, xs[i + 2]);
        ARITH4_STEP(lo3, rg3, w3, m3, xs[i + 3]);
    }
    if (i < n) { ARITH4_STEP(lo0, rg0, w0, m0, xs[i]); i++; }
    if (i < n) { ARITH4_STEP(lo1, rg1, w1, m1, xs[i]); i++; }
    if (i < n) { ARITH4_STEP(lo2, rg2, w2, m2, xs[i]); i++; }
#undef ARITH4_STEP
    for (int j = 0; j < 8; j++) {
        if (w0 >= m0 || w1 >= m1 || w2 >= m2 || w3 >= m3) return -1;
        out[w0++] = (uint8_t)(lo0 >> 56); lo0 <<= 8;
        out[w1++] = (uint8_t)(lo1 >> 56); lo1 <<= 8;
        out[w2++] = (uint8_t)(lo2 >> 56); lo2 <<= 8;
        out[w3++] = (uint8_t)(lo3 >> 56); lo3 <<= 8;
    }
    len4[0] = w0;
    len4[1] = w1 - cap4;
    len4[2] = w2 - 2 * cap4;
    len4[3] = w3 - 3 * cap4;
    return 0;
}

// 4-substream decode twin: chain j reads its own byte range
// [off[j], off[j]+slen[j]) and produces out_ids[j], out_ids[j+4], ...
// Reads past a chain's end are explicit zeros (the `p < end` select),
// so substream concatenation cannot leak bytes across chains.  jump:
// 2^16+1 entries, jump[b] = last k with cum[k] <= b << (tl2-16) —
// narrows the per-symbol cumulative search to one bucket.
int64_t arith_decode4(const uint8_t* buf, const int64_t* off,
                      const int64_t* slen, const uint64_t* cum,
                      uint32_t tl2, const uint32_t* jump, int64_t n,
                      uint32_t* out_ids) {
    const uint64_t total = 1ULL << tl2;
    const uint32_t jshift = tl2 - 16;
    uint64_t lo0 = 0, lo1 = 0, lo2 = 0, lo3 = 0;
    uint64_t rg0 = ~0ULL, rg1 = ~0ULL, rg2 = ~0ULL, rg3 = ~0ULL;
    uint64_t cd0 = 0, cd1 = 0, cd2 = 0, cd3 = 0;
    int64_t p0 = off[0], p1 = off[1], p2 = off[2], p3 = off[3];
    const int64_t e0 = p0 + slen[0], e1 = p1 + slen[1];
    const int64_t e2 = p2 + slen[2], e3 = p3 + slen[3];
    for (int j = 0; j < 8; j++) {
        cd0 = (cd0 << 8) | (p0 < e0 ? buf[p0++] : (p0++, 0));
        cd1 = (cd1 << 8) | (p1 < e1 ? buf[p1++] : (p1++, 0));
        cd2 = (cd2 << 8) | (p2 < e2 ? buf[p2++] : (p2++, 0));
        cd3 = (cd3 << 8) | (p3 < e3 ? buf[p3++] : (p3++, 0));
    }

#define ARITH4_DEC(low, rng, code, p, end, dst)                            \
    do {                                                                   \
        uint64_t r = (rng) >> tl2;                                         \
        if (!r) return -1; /* collapsed range = corrupt stream/model */    \
        uint64_t target = ((code) - (low)) / r;                            \
        if (target > total - 1) target = total - 1;                        \
        uint64_t b = target >> jshift;                                     \
        int64_t lo_ = jump[b], hi_ = (int64_t)jump[b + 1] + 1;             \
        while (hi_ - lo_ > 1) {                                            \
            int64_t mid = (lo_ + hi_) >> 1;                                \
            if (cum[mid] <= target) lo_ = mid; else hi_ = mid;             \
        }                                                                  \
        (dst) = (uint32_t)lo_;                                             \
        uint64_t f = cum[lo_ + 1] - cum[lo_];                              \
        (low) += r * cum[lo_];                                             \
        (rng) = r * f;                                                     \
        for (;;) {                                                         \
            if (((low) ^ ((low) + (rng))) < ARITH_TOP) {                   \
            } else if ((rng) < ARITH_BOT) {                                \
                (rng) = (0 - (low)) & (ARITH_BOT - 1);                     \
            } else {                                                       \
                break;                                                     \
            }                                                              \
            (code) = ((code) << 8) | ((p) < (end) ? buf[(p)++] : ((p)++, 0)); \
            (low) <<= 8;                                                   \
            (rng) <<= 8;                                                   \
        }                                                                  \
    } while (0)

    int64_t i = 0;
    int64_t n4 = n & ~(int64_t)3;
    for (; i < n4; i += 4) {
        ARITH4_DEC(lo0, rg0, cd0, p0, e0, out_ids[i]);
        ARITH4_DEC(lo1, rg1, cd1, p1, e1, out_ids[i + 1]);
        ARITH4_DEC(lo2, rg2, cd2, p2, e2, out_ids[i + 2]);
        ARITH4_DEC(lo3, rg3, cd3, p3, e3, out_ids[i + 3]);
    }
    if (i < n) { ARITH4_DEC(lo0, rg0, cd0, p0, e0, out_ids[i]); i++; }
    if (i < n) { ARITH4_DEC(lo1, rg1, cd1, p1, e1, out_ids[i]); i++; }
    if (i < n) { ARITH4_DEC(lo2, rg2, cd2, p2, e2, out_ids[i]); i++; }
#undef ARITH4_DEC
    return 0;
}

}  // extern "C"

// ------------------------------------------------- interpolative coder ---
// Bit-exact C++ twin of reference_model/interp.py + bitio.py (LSB-first
// bits in little-endian u32 words; recursion as an explicit stack).

namespace {

struct BitWriterN {
    uint8_t* out;
    int64_t cap;
    int64_t word_count = 0;
    uint64_t cur = 0;
    int off = 0;
    bool overflow = false;

    void put(uint64_t val, int bits) {
        if (bits == 0) return;
        if (bits > 32) {  // keep cur within 64 bits (off < 32 + 32)
            put(val & 0xFFFFFFFFull, 32);
            put(val >> 32, bits - 32);
            return;
        }
        val &= (1ull << bits) - 1;
        cur |= val << off;
        off += bits;
        while (off >= 32) {
            if (4 * word_count + 4 > cap) { overflow = true; return; }
            uint32_t w = (uint32_t)cur;
            memcpy(out + 4 * word_count, &w, 4);
            word_count++;
            cur >>= 32;
            off -= 32;
        }
    }
    int64_t flush() {
        if (off) {
            if (4 * word_count + 4 > cap) return -1;
            uint32_t w = (uint32_t)cur;
            memcpy(out + 4 * word_count, &w, 4);
            word_count++;
            cur = 0;
            off = 0;
        }
        return 4 * word_count;
    }
};

struct BitReaderN {
    const uint8_t* buf;
    int64_t nbytes;
    int64_t pos;  // bit position

    uint64_t get(int bits) {
        if (bits == 0) return 0;
        if (bits > 32) {
            uint64_t lo = get(32);
            return lo | (get(bits - 32) << 32);
        }
        int64_t p = pos;
        pos += bits;
        int64_t byte0 = p >> 3;
        uint64_t v = 0;
        for (int i = 0; i < 8; i++) {
            uint64_t b = (byte0 + i < nbytes) ? buf[byte0 + i] : 0;
            v |= b << (8 * i);
        }
        return (v >> (p & 7)) & ((bits >= 64) ? ~0ull : ((1ull << bits) - 1));
    }
};

static inline int hibit(uint64_t x) {
    return x ? 63 - __builtin_clzll(x) : 0;
}

static void write_center_mid(BitWriterN& w, uint64_t val, uint64_t u) {
    if (u == 1) return;
    int b = hibit(u - 1) + 1;
    uint64_t d = 2 * u - (1ull << b);
    val = val + (u - (d >> 1));
    if (val > u) val -= u;
    uint64_t m = (1ull << b) - u;
    if (val <= m) {
        w.put(val - 1, b - 1);
    } else {
        val += m;
        w.put((val - 1) >> 1, b - 1);
        w.put((val - 1) & 1, 1);
    }
}

static uint64_t read_center_mid(BitReaderN& r, uint64_t u) {
    int b = (u == 1) ? 0 : hibit(u - 1) + 1;
    uint64_t d = 2 * u - (1ull << b);
    uint64_t val = 1;
    if (u != 1) {
        uint64_t m = (1ull << b) - u;
        val = r.get(b - 1) + 1;
        if (val > m) val = (2 * val + r.get(1)) - m - 1;
    }
    val += d >> 1;
    if (val > u) val -= u;
    return val;
}

struct Frame { int64_t start, n; uint64_t low, high; };

}  // namespace

extern "C" {

// Encode seq[0:n] (strictly increasing u64, values in [0,u)) over
// universe u; returns bytes written (whole words) or -1 on overflow.
int64_t ans_interp_encode(const uint64_t* seq, int64_t n, uint64_t u,
                          uint8_t* out, int64_t cap) {
    BitWriterN w{out, cap};
    // DFS: each pop pushes both halves and the left is consumed next,
    // so at most one pending sibling per level — depth <= 64 + margin
    Frame stack[160];
    int64_t sp = 0;
    stack[sp++] = {0, n, 1, u + 1};
    while (sp) {
        Frame f = stack[--sp];
        if (f.n == 0) continue;
        int64_t h = (f.n + 1) >> 1;
        int64_t n1 = h - 1;
        int64_t n2 = f.n - h;
        uint64_t v = seq[f.start + h - 1] + 1;
        write_center_mid(w, v - f.low - n1 + 1,
                         f.high - n2 - f.low - n1 + 1);
        stack[sp++] = {f.start + h, n2, v + 1, f.high};
        stack[sp++] = {f.start, n1, f.low, v - 1};
        if (w.overflow) return -1;
    }
    return w.flush();
}

// Decode n values over universe u starting at bit_offset; returns words
// consumed (relative to bit_offset).
int64_t ans_interp_decode(const uint8_t* buf, int64_t nbytes, int64_t n,
                          uint64_t u, int64_t bit_offset, uint64_t* out) {
    BitReaderN r{buf, nbytes, bit_offset};
    Frame stack[160];             // DFS depth <= 64 + margin (see encode)
    int64_t sp = 0;
    stack[sp++] = {0, n, 1, u + 1};
    while (sp) {
        Frame f = stack[--sp];
        if (f.n == 0) continue;
        int64_t h = (f.n + 1) >> 1;
        int64_t n1 = h - 1;
        int64_t n2 = f.n - h;
        uint64_t v = f.low + n1 - 1
            + read_center_mid(r, f.high - n2 - f.low - n1 + 1);
        out[f.start + h - 1] = v - 1;
        stack[sp++] = {f.start + h, n2, v + 1, f.high};
        stack[sp++] = {f.start, n1, f.low, v - 1};
    }
    return (r.pos - bit_offset + 31) / 32;
}

}  // extern "C"
