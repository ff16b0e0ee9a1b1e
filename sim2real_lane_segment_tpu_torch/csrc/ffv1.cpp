// FFV1 lossless video codec (RFC 9043), versions 2 and 3 at 8 bits.
//
// The JAX package records FFV1 AVIs through cv2 (FFmpeg's encoder); this
// file lets the port read and write them without cv2.  It is host code with
// a plain C interface, loaded by ``data/ffv1.py`` through ctypes.
//
// Decoder: versions 2 and 3; colorspace 1 (RGB through the reversible
// colour transform, with or without an alpha plane, which is dropped) and
// colorspace 0 without chroma planes (grey); any slice grid; Golomb-Rice
// (coder 0) or range-coded (coder 1, default states; coder 2, custom state
// table) samples.  Every CRC is checked when the stream has them.  The
// slices of a frame are decoded in parallel; frames in order, since a
// slice's context states carry over from one frame to the next until the
// next keyframe.  Output is BGR, grey expanded to three channels.
//
// Encoder: what FFmpeg writes by default (version 3, micro-version 4,
// Golomb-Rice, RGB with an alpha plane, CRCs, a 2x2 slice grid, a keyframe
// every 12 frames, the same quantisation tables), with the version, coder,
// slice grid, keyframe interval and alpha plane as parameters.
//
// Names follow the RFC: a plane's samples are predicted from their left
// (L), top-left (TL), top (T) and top-right (TR) neighbours (and LL, TT
// with five-input quantisation tables); the quantised differences of the
// neighbours pick a context; the residual is coded with that context's
// adaptive Golomb-Rice parameters or range-coder states.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int CONTEXT_SIZE = 32;    // range-coder states of one context
constexpr int MAX_QUANT_TABLES = 8;
constexpr int MAX_CONTEXT_INPUTS = 5;
constexpr int MAX_SLICES = 1024;
constexpr int MAX_PLANE_SETS = 3;   // luma/G, chroma/B-R, alpha
constexpr int GOLOMB_LIMIT = 12;

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

std::string fmt(const char* f, long a = 0, long b = 0, long c = 0) {
    char buf[256];
    std::snprintf(buf, sizeof buf, f, a, b, c);
    return buf;
}

// ---------------------------------------------------------------- CRC-32
// Polynomial 0x04C11DB7, most significant bit first, initial value 0, no
// final xor: a block followed by its CRC (big-endian) has CRC 0.
struct CrcTable {
    uint32_t t[256];
    CrcTable() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i << 24;
            for (int k = 0; k < 8; k++)
                c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
            t[i] = c;
        }
    }
};
const CrcTable kCrc;

uint32_t crc32(const uint8_t* p, size_t n) {
    uint32_t crc = 0;
    for (size_t i = 0; i < n; i++)
        crc = (crc << 8) ^ kCrc.t[(crc >> 24) ^ p[i]];
    return crc;
}

void put_be(std::vector<uint8_t>& out, uint32_t v, int bytes) {
    for (int i = bytes - 1; i >= 0; i--) out.push_back(uint8_t(v >> (8 * i)));
}

uint32_t get_be24(const uint8_t* p) {
    return (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
}

// ---------------------------------------------------------- range coder
struct StateTables {
    uint8_t zero[256];
    uint8_t one[256];
};

// The default state transition table (RFC 9043 4.1.1): FFmpeg's
// ff_build_rac_states with factor 0.05 * 2^32 and max_p 248.
StateTables build_default_states() {
    StateTables s{};
    const int64_t one = int64_t(1) << 32;
    const int64_t factor = int64_t(0.05 * double(one));
    const int max_p = 256 - 8;
    int64_t p = one / 2;
    int last_p8 = 0;
    for (int i = 0; i < 128; i++) {
        int p8 = int((256 * p + one / 2) >> 32);
        if (p8 <= last_p8) p8 = last_p8 + 1;
        if (last_p8 && last_p8 < 256 && p8 <= max_p) s.one[last_p8] = uint8_t(p8);
        p += ((one - p) * factor + one / 2) >> 32;
        last_p8 = p8;
    }
    for (int i = 256 - max_p; i <= max_p; i++) {
        if (s.one[i]) continue;
        p = (i * one + 128) >> 8;
        p += ((one - p) * factor + one / 2) >> 32;
        int p8 = int((256 * p + one / 2) >> 32);
        if (p8 <= i) p8 = i + 1;
        if (p8 > max_p) p8 = max_p;
        s.one[i] = uint8_t(p8);
    }
    for (int i = 1; i < 255; i++) s.zero[i] = uint8_t(256 - s.one[256 - i]);
    return s;
}
const StateTables kDefaultStates = build_default_states();

StateTables custom_states(const uint8_t transition[256]) {
    StateTables s = kDefaultStates;
    for (int i = 1; i < 256; i++) {
        s.one[i] = transition[i];
        s.zero[256 - i] = uint8_t(256 - transition[i]);
    }
    return s;
}

struct RangeDecoder {
    const uint8_t* start = nullptr;
    const uint8_t* pos = nullptr;
    const uint8_t* end = nullptr;
    uint32_t low = 0, range = 0;
    const StateTables* tab = &kDefaultStates;

    void init(const uint8_t* buf, size_t size) {
        start = pos = buf;
        end = buf + size;
        low = (size > 0 ? uint32_t(buf[0]) << 8 : 0) | (size > 1 ? buf[1] : 0);
        pos += 2;
        range = 0xFF00;
        if (low >= 0xFF00) {
            low = 0xFF00;
            end = pos;
        }
    }
    inline void refill() {
        if (range < 0x100) {
            range <<= 8;
            low <<= 8;
            if (pos < end) low += *pos++;
        }
    }
    inline int bit(uint8_t* state) {
        uint32_t range1 = (range * *state) >> 8;
        range -= range1;
        if (low < range) {
            *state = tab->zero[*state];
            refill();
            return 0;
        }
        low -= range;
        *state = tab->one[*state];
        range = range1;
        refill();
        return 1;
    }
    // A symbol coded with the 32 states at ``state`` (RFC 9043 3.8.1.2).
    int symbol(uint8_t* state, bool is_signed) {
        if (bit(state)) return 0;
        int e = 0;
        while (bit(state + 1 + std::min(e, 9))) {
            if (++e > 31) throw Error("range-coded symbol too large");
        }
        uint32_t a = 1;
        for (int i = e - 1; i >= 0; i--) a += a + bit(state + 22 + std::min(i, 9));
        int neg = is_signed && bit(state + 11 + std::min(e, 10));
        return neg ? -int(a) : int(a);
    }
};

struct RangeEncoder {
    std::vector<uint8_t> out;
    int low = 0, range = 0xFF00, outstanding_count = 0, outstanding_byte = -1;
    const StateTables* tab = &kDefaultStates;

    void renorm() {
        while (range < 0x100) {
            if (outstanding_byte < 0) {
                outstanding_byte = low >> 8;
            } else if (low <= 0xFF00) {
                out.push_back(uint8_t(outstanding_byte));
                for (; outstanding_count; outstanding_count--) out.push_back(0xFF);
                outstanding_byte = low >> 8;
            } else if (low >= 0x10000) {
                out.push_back(uint8_t(outstanding_byte + 1));
                for (; outstanding_count; outstanding_count--) out.push_back(0x00);
                outstanding_byte = (low >> 8) - 0x100;
            } else {
                outstanding_count++;
            }
            low = (low & 0xFF) << 8;
            range <<= 8;
        }
    }
    inline void bit(uint8_t* state, int b) {
        int range1 = (range * *state) >> 8;
        if (!b) {
            range -= range1;
            *state = tab->zero[*state];
        } else {
            low += range - range1;
            range = range1;
            *state = tab->one[*state];
        }
        renorm();
    }
    void symbol(uint8_t* state, int v, bool is_signed) {
        if (!v) {
            bit(state, 1);
            return;
        }
        const int a = v < 0 ? -v : v;
        const int e = 31 - __builtin_clz(unsigned(a));
        bit(state, 0);
        for (int i = 0; i < e; i++) bit(state + 1 + std::min(i, 9), 1);
        bit(state + 1 + std::min(e, 9), 0);
        for (int i = e - 1; i >= 0; i--) bit(state + 22 + std::min(i, 9), (a >> i) & 1);
        if (is_signed) bit(state + 11 + std::min(e, 10), v < 0);
    }
    // Ends the coded bytes; ``with_marker`` first codes a 0 with state 129,
    // which a version-3 decoder reads before the Golomb-Rice bits or at the
    // end of a range-coded slice.  The decoder reads one byte past the last
    // one written; ``next`` (0-255) is that byte where the caller knows it:
    // the end is then placed so that the coded bits decode right followed by
    // it, which a range of at least 0x100 always allows.  Without a marker
    // to absorb the error, FFmpeg's end (``low + 0xFF``) can misdecode the
    // last bits when the following byte is large.  Returns the byte count.
    size_t terminate(bool with_marker, int next = -1) {
        if (with_marker) {
            uint8_t s = 129;
            bit(&s, 0);
        }
        range = 0xFF;
        low += next < 0 ? 0xFF : (next - low) & 0xFF;
        renorm();
        range = 0xFF;
        renorm();
        return out.size();
    }
};

// --------------------------------------------------------- Golomb-Rice
struct BitReader {
    const uint8_t* start = nullptr;
    const uint8_t* pos = nullptr;
    const uint8_t* end = nullptr;
    uint64_t cache = 0;   // next bits, most significant first
    int avail = 0;        // valid bits in cache

    void init(const uint8_t* b, const uint8_t* e) {
        start = pos = b;
        end = e;
        cache = 0;
        avail = 0;
    }
    inline void fill() {
        if (avail > 56) return;
        if (end - pos >= 8) {   // whole bytes from one big-endian load; the
            uint64_t v;         // bits below them are the stream's next
            std::memcpy(&v, pos, 8);
            cache |= __builtin_bswap64(v) >> avail;
            pos += (63 - avail) >> 3;
            avail |= 56;
            return;
        }
        while (avail <= 56) {
            uint64_t byte = pos < end ? *pos : 0;
            pos++;
            cache |= byte << (56 - avail);
            avail += 8;
        }
    }
    inline uint32_t get(int n) {   // n <= 32, after fill() with n <= avail
        if (!n) return 0;
        uint32_t v = uint32_t(cache >> (64 - n));
        cache <<= n;
        avail -= n;
        return v;
    }
    inline int get1() {
        fill();
        return int(get(1));
    }
    inline uint32_t bits(int n) {
        fill();
        return get(n);
    }
    bool overread() const {   // more bits consumed than the slice holds
        return (pos - start) * 8 - avail > (end - start) * 8;
    }
    // Unsigned Golomb-Rice code with parameter k, escape after ``limit``
    // zeros to ``esc_len`` raw bits (FFmpeg's get_ur_golomb).
    inline int ur_golomb(int k, int esc_len) {
        fill();
        int q = cache ? __builtin_clzll(cache) : 64;
        if (q < GOLOMB_LIMIT) {   // q + 1 + k < 57 bits: one fill does
            get(q + 1);
            return int((uint32_t(q) << k) + get(k));
        }
        get(GOLOMB_LIMIT);
        return int(get(esc_len)) + GOLOMB_LIMIT - 1;
    }
};

struct BitWriter {
    std::vector<uint8_t>* out;
    uint64_t acc = 0;
    int n = 0;   // bits in acc

    explicit BitWriter(std::vector<uint8_t>* o) : out(o) {}
    inline void put(int bits, uint32_t v) {   // bits <= 32
        if (!bits) return;
        acc = (acc << bits) | (v & (bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1)));
        n += bits;
        if (n >= 32) {   // n < 32 before, so acc held every pending bit
            n -= 32;
            const uint32_t word = uint32_t(acc >> n);
            const uint8_t b[4] = {uint8_t(word >> 24), uint8_t(word >> 16),
                                  uint8_t(word >> 8), uint8_t(word)};
            out->insert(out->end(), b, b + 4);
        }
    }
    void flush() {
        for (; n >= 8; n -= 8) out->push_back(uint8_t(acc >> (n - 8)));
        if (n) out->push_back(uint8_t(acc << (8 - n)));
        n = 0;
        acc = 0;
    }
    inline void ur_golomb(int i, int k, int esc_len) {
        int e = i >> k;
        if (e < GOLOMB_LIMIT)
            put(e + k + 1, (1u << k) + (uint32_t(i) & ((1u << k) - 1)));
        else
            put(GOLOMB_LIMIT + esc_len, uint32_t(i - GOLOMB_LIMIT + 1));
    }
};

// JPEG-LS run lengths: a run-mode 1 bit stands for 2^kLog2Run[index] samples
const uint8_t kLog2Run[41] = {0,  0,  0,  0,  1,  1,  1,  1,  2,  2,  2,  2,  3,  3,
                              3,  3,  4,  4,  5,  5,  6,  6,  7,  7,  8,  9,  10, 11,
                              12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

struct VlcState {
    int drift = 0;
    int error_sum = 4;
    int bias = 0;
    int count = 1;

    // The least k with count * 2^k >= error_sum.
    inline int k() const {
        if (count >= error_sum) return 0;
        int k = __builtin_clz(unsigned(count)) - __builtin_clz(unsigned(error_sum));
        return (count << k) < error_sum ? k + 1 : k;
    }
    inline void update(int v) {
        error_sum += v < 0 ? -v : v;
        drift += v;
        if (count == 128) {
            count >>= 1;
            drift >>= 1;   // arithmetic, as in FFmpeg
            error_sum >>= 1;
        }
        count++;
        if (drift <= -count) {
            bias = std::max(bias - 1, -128);
            drift = std::max(drift + count, -count + 1);
        } else if (drift > 0) {
            bias = std::min(bias + 1, 127);
            drift = std::min(drift - count, 0);
        }
    }
};

// Sign-extend a residual from ``bits`` bits.
inline int fold(int diff, int bits) {
    const int shift = 32 - bits;
    return int(uint32_t(diff) << shift) >> shift;
}

inline int get_vlc_symbol(BitReader& br, VlcState& s, int bits) {
    const int k = s.k();
    int v = br.ur_golomb(k, bits);
    v = (v >> 1) ^ -(v & 1);
    v ^= (2 * s.drift + s.count) >> 31;
    const int ret = fold(v + s.bias, bits);
    s.update(v);
    return ret;
}

inline void put_vlc_symbol(BitWriter& bw, VlcState& s, int v, int bits) {
    v = fold(v - s.bias, bits);
    const int k = s.k();
    int code = v ^ ((2 * s.drift + s.count) >> 31);
    int u = -2 * code - 1;
    u ^= u >> 31;
    bw.ur_golomb(u, k, bits);
    s.update(v);
}

// ------------------------------------------------ quantisation, contexts
struct QuantTable {
    int16_t q[MAX_CONTEXT_INPUTS][256];
    int context_count;
    bool five_inputs() const { return q[3][127] || q[4][127]; }
};

inline int mid_pred(int a, int b, int c) {   // the median, without branches
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ``cur`` is the row being coded at x (it still holds the row two above at
// x and right of it), ``top`` the row above.
inline int context_of(const QuantTable& t, const int* cur, const int* top) {
    const int LT = top[-1], T = top[0], RT = top[1], L = cur[-1];
    int c = t.q[0][(L - LT) & 0xFF] + t.q[1][(LT - T) & 0xFF] + t.q[2][(T - RT) & 0xFF];
    if (t.five_inputs()) c += t.q[3][(cur[-2] - L) & 0xFF] + t.q[4][(cur[0] - T) & 0xFF];
    return c;
}

inline int predict(const int* cur, const int* top) {
    const int LT = top[-1], T = top[0], L = cur[-1];
    return mid_pred(L, L + T - LT, T);
}

// FFmpeg's encoder tables (quant11 and quant5), first halves: entry i of
// the table for differences 0..127; the rest mirrors them.
int quant11(int i) {
    return i == 0 ? 0 : i == 1 ? 1 : i < 5 ? 2 : i < 12 ? 3 : i < 35 ? 4 : 5;
}
int quant5(int i) { return i == 0 ? 0 : i < 4 ? 1 : 2; }

void mirror(int16_t* q) {
    for (int i = 1; i < 128; i++) q[256 - i] = int16_t(-q[i]);
    q[128] = int16_t(-q[127]);
}

// The two table sets FFmpeg writes at 8 bits: 3 inputs (11 x 11 x 11
// contexts, halved by sign) and 5 inputs (11 x 11 x 5 x 5 x 5).
void default_quant_tables(QuantTable t[2]) {
    std::memset(t, 0, 2 * sizeof(QuantTable));
    for (int i = 0; i < 128; i++) {
        t[0].q[0][i] = int16_t(quant11(i));
        t[0].q[1][i] = int16_t(11 * quant11(i));
        t[0].q[2][i] = int16_t(11 * 11 * quant11(i));
        t[1].q[0][i] = int16_t(quant11(i));
        t[1].q[1][i] = int16_t(11 * quant11(i));
        t[1].q[2][i] = int16_t(11 * 11 * quant5(i));
        t[1].q[3][i] = int16_t(5 * 11 * 11 * quant5(i));
        t[1].q[4][i] = int16_t(5 * 5 * 11 * 11 * quant5(i));
    }
    for (int s = 0; s < 2; s++)
        for (int j = 0; j < MAX_CONTEXT_INPUTS; j++) mirror(t[s].q[j]);
    t[0].context_count = (11 * 11 * 11 + 1) / 2;
    t[1].context_count = (11 * 11 * 5 * 5 * 5 + 1) / 2;
}

int read_quant_table(RangeDecoder& c, int16_t* q, int scale) {
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    int i = 0, v = 0;
    for (; i < 128; v++) {
        unsigned len = unsigned(c.symbol(state, false)) + 1u;
        if (len > unsigned(128 - i) || !len) throw Error("bad quantisation table");
        while (len--) q[i++] = int16_t(scale * v);
    }
    mirror(q);
    return 2 * v - 1;
}

void write_quant_table(RangeEncoder& c, const int16_t* q) {
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    int last = 0, i = 1;
    for (; i < 128; i++)
        if (q[i] != q[i - 1]) {
            c.symbol(state, i - last - 1, false);
            last = i;
        }
    c.symbol(state, i - last - 1, false);
}

// ------------------------------------------------------ stream settings
struct Config {
    int version = 3, micro_version = 4, coder = 0, colorspace = 1, bits = 8;
    int chroma_planes = 1, chroma_h_shift = 0, chroma_v_shift = 0, transparency = 1;
    int num_h_slices = 2, num_v_slices = 2, ec = 1, intra = 0;
    int quant_table_count = 2;
    QuantTable quant[MAX_QUANT_TABLES];
    std::vector<uint8_t> initial_states[MAX_QUANT_TABLES];   // empty: all 128
    uint8_t transition[256];                                  // coder 2
    StateTables states = kDefaultStates;                      // for samples

    // Context sets coded in a slice header: luma, chroma (even when absent,
    // before version 4) and alpha.
    int plane_count() const { return 1 + (chroma_planes || version < 4) + transparency; }
};

void parse_config(const uint8_t* data, size_t size, int width, int height, Config& f) {
    if (size == 0)
        throw Error("FFV1 version 0 or 1 (no configuration record) is not supported; "
                    "only versions 2 and 3 are decoded");
    RangeDecoder c;
    c.init(data, size);
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    f.version = c.symbol(state, false);
    if (f.version < 2)
        throw Error(fmt("FFV1 version %ld is not supported; only versions 2 and 3 are "
                        "decoded", f.version));
    if (f.version > 3)
        throw Error(fmt("FFV1 version %ld is not supported; only versions 2 and 3 are "
                        "decoded", f.version));
    if (f.version > 2) {
        if (size < 4 || crc32(data, size) != 0)
            throw Error("FFV1 configuration record: CRC mismatch");
        c.end -= 4;
        f.micro_version = c.symbol(state, false);
    } else {
        f.micro_version = 0;
    }
    f.coder = c.symbol(state, false);
    if (f.coder > 2) throw Error(fmt("FFV1 coder_type %ld is not supported", f.coder));
    if (f.coder == 2) {
        for (int i = 1; i < 256; i++) {
            int st = c.symbol(state, true) + kDefaultStates.one[i];
            if (st < 1 || st > 255) throw Error("FFV1 state transition table out of range");
            f.transition[i] = uint8_t(st);
        }
        f.states = custom_states(f.transition);
    }
    f.colorspace = c.symbol(state, false);
    f.bits = c.symbol(state, false);
    f.chroma_planes = c.bit(state);
    f.chroma_h_shift = c.symbol(state, false);
    f.chroma_v_shift = c.symbol(state, false);
    f.transparency = c.bit(state);
    f.num_h_slices = 1 + c.symbol(state, false);
    f.num_v_slices = 1 + c.symbol(state, false);
    if (f.bits == 0) f.bits = 8;
    if (f.bits > 8)
        throw Error(fmt("FFV1 at %ld bits per sample is not supported; only 8 bits are "
                        "decoded", f.bits));
    if (f.colorspace > 1)
        throw Error(fmt("FFV1 colorspace %ld is not supported", f.colorspace));
    if (f.colorspace == 0 && f.chroma_planes)
        throw Error("FFV1 colorspace 0 with chroma planes (YCbCr) is not supported; "
                    "only RGB and grey are decoded");
    if (f.colorspace == 0 && f.transparency)
        throw Error("FFV1 grey with an alpha plane is not supported");
    if (f.colorspace == 1 && (!f.chroma_planes || f.chroma_h_shift || f.chroma_v_shift))
        throw Error("FFV1 RGB stream without full-size planes");
    if (f.num_h_slices > width || f.num_v_slices > height || f.num_h_slices < 1 ||
        f.num_v_slices < 1 || f.num_h_slices * f.num_v_slices > MAX_SLICES)
        throw Error(fmt("FFV1 slice grid %ldx%ld does not fit the frame", f.num_h_slices,
                        f.num_v_slices));
    f.quant_table_count = c.symbol(state, false);
    if (f.quant_table_count < 1 || f.quant_table_count > MAX_QUANT_TABLES)
        throw Error("FFV1 quantisation table count out of range");
    for (int i = 0; i < f.quant_table_count; i++) {
        int count = 1;
        for (int j = 0; j < MAX_CONTEXT_INPUTS; j++) {
            count *= read_quant_table(c, f.quant[i].q[j], count);
            if (count > 32768 || count < 1) throw Error("FFV1 too many contexts");
        }
        f.quant[i].context_count = (count + 1) / 2;
    }
    uint8_t state2[CONTEXT_SIZE][CONTEXT_SIZE];
    std::memset(state2, 128, sizeof state2);
    for (int i = 0; i < f.quant_table_count; i++) {
        f.initial_states[i].clear();
        if (!c.bit(state)) continue;
        const int n = f.quant[i].context_count;
        auto& init = f.initial_states[i];
        init.assign(size_t(n) * CONTEXT_SIZE, 128);
        for (int j = 0; j < n; j++)
            for (int k = 0; k < CONTEXT_SIZE; k++) {
                int pred = j ? init[(j - 1) * CONTEXT_SIZE + k] : 128;
                init[j * CONTEXT_SIZE + k] = uint8_t((pred + c.symbol(state2[k], true)) & 0xFF);
            }
    }
    if (f.version > 2) {
        f.ec = c.symbol(state, false);
        if (f.micro_version > 2) f.intra = c.symbol(state, false);
    } else {
        f.ec = 0;
    }
}

std::vector<uint8_t> write_config(const Config& f) {
    RangeEncoder c;
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    c.symbol(state, f.version, false);
    if (f.version > 2) c.symbol(state, f.micro_version, false);
    c.symbol(state, f.coder, false);
    if (f.coder == 2)
        for (int i = 1; i < 256; i++)
            c.symbol(state, f.transition[i] - kDefaultStates.one[i], true);
    c.symbol(state, f.colorspace, false);
    c.symbol(state, f.bits, false);
    c.bit(state, f.chroma_planes);
    c.symbol(state, f.chroma_h_shift, false);
    c.symbol(state, f.chroma_v_shift, false);
    c.bit(state, f.transparency);
    c.symbol(state, f.num_h_slices - 1, false);
    c.symbol(state, f.num_v_slices - 1, false);
    c.symbol(state, f.quant_table_count, false);
    for (int i = 0; i < f.quant_table_count; i++)
        for (int j = 0; j < MAX_CONTEXT_INPUTS; j++) write_quant_table(c, f.quant[i].q[j]);
    uint8_t state2[CONTEXT_SIZE][CONTEXT_SIZE];
    std::memset(state2, 128, sizeof state2);
    for (int i = 0; i < f.quant_table_count; i++) {
        const auto& init = f.initial_states[i];
        c.bit(state, !init.empty());
        for (size_t j = 0; j < init.size(); j++) {   // deltas along contexts
            const int pred = j < CONTEXT_SIZE ? 128 : init[j - CONTEXT_SIZE];
            c.symbol(state2[j % CONTEXT_SIZE], int8_t(init[j] - pred), true);
        }
    }
    if (f.version > 2) {
        c.symbol(state, f.ec, false);
        c.symbol(state, f.intra, false);
    }
    c.terminate(false);
    std::vector<uint8_t> out = c.out;
    if (f.version > 2) put_be(out, crc32(out.data(), out.size()), 4);
    return out;
}

// --------------------------------------------------------------- slices
struct PlaneCtx {
    int quant_index = -1;
    int context_count = 0;
    std::vector<uint8_t> state;   // context_count x CONTEXT_SIZE
    std::vector<VlcState> vlc;    // context_count

    void reset(const Config& f) {
        const QuantTable& t = f.quant[quant_index];
        context_count = t.context_count;
        if (f.coder) {
            const auto& init = f.initial_states[quant_index];
            if (init.empty())
                state.assign(size_t(context_count) * CONTEXT_SIZE, 128);
            else
                state = init;
        } else {
            vlc.assign(size_t(context_count), VlcState());
        }
    }
};

struct SliceCtx {
    int sx = 0, sy = 0;            // grid position
    int x = 0, y = 0, w = 0, h = 0;
    PlaneCtx planes[MAX_PLANE_SETS];
    int run_index = 0;
    std::vector<int> rows;         // line buffers
};

inline int slice_coord(int size, int i, int n) { return int(int64_t(size) * i / n); }

// One line of samples: the decoder's and the encoder's sides mirror each
// other (RFC 9043 3.8: contexts, prediction, Golomb-Rice run mode).
struct LineDecoder {
    RangeDecoder* rc;
    BitReader* br;
    bool golomb;

    // Decodes one line of ``w`` samples into cur[0..w) (``bits``-bit
    // samples); ``top`` is the row above.
    void line(const Config& f, SliceCtx& s, PlaneCtx& p, int w, int* cur, const int* top,
              int bits) {
        const QuantTable& q = f.quant[p.quant_index];
        const int mask = (1 << bits) - 1;
        int run_index = s.run_index, run_count = 0, run_mode = 0;
        for (int x = 0; x < w; x++) {
            int context = context_of(q, cur + x, top + x);
            int sign = 0;
            if (context < 0) {
                context = -context;
                sign = 1;
            }
            int diff;
            if (!golomb) {
                diff = rc->symbol(&p.state[size_t(context) * CONTEXT_SIZE], true);
            } else {
                if (context == 0 && run_mode == 0) run_mode = 1;
                if (run_mode) {
                    if (run_count == 0 && run_mode == 1) {
                        if (br->get1()) {
                            run_count = 1 << kLog2Run[run_index];
                            if (x + run_count <= w) run_index++;
                        } else {
                            run_count = int(br->bits(kLog2Run[run_index]));
                            if (run_index) run_index--;
                            run_mode = 2;
                        }
                        if (run_index > 40) throw Error("run index out of range");
                    }
                    // a run's samples equal their prediction (the top
                    // sample when L == TL; not always, since contexts see
                    // 9-bit differences modulo 256)
                    while (run_count > 1 && w - x > 1) {
                        cur[x] = predict(cur + x, top + x);
                        x++;
                        run_count--;
                    }
                    run_count--;
                    if (run_count < 0) {
                        run_mode = 0;
                        run_count = 0;
                        diff = get_vlc_symbol(*br, p.vlc[size_t(context)], bits);
                        if (diff >= 0) diff++;
                    } else {
                        diff = 0;
                    }
                } else {
                    diff = get_vlc_symbol(*br, p.vlc[size_t(context)], bits);
                }
            }
            if (sign) diff = -diff;
            cur[x] = (predict(cur + x, top + x) + diff) & mask;
        }
        s.run_index = run_index;
        if (golomb && br->overread()) throw Error("slice data ends early");
    }
};

struct LineEncoder {
    RangeEncoder* rc;
    BitWriter* bw;
    bool golomb;

    void line(const Config& f, SliceCtx& s, PlaneCtx& p, int w, const int* cur, const int* top,
              int bits) {
        const QuantTable& q = f.quant[p.quant_index];
        int run_index = s.run_index, run_count = 0, run_mode = 0;
        for (int x = 0; x < w; x++) {
            int context = context_of(q, cur + x, top + x);
            int diff = cur[x] - predict(cur + x, top + x);
            if (context < 0) {
                context = -context;
                diff = -diff;
            }
            diff = fold(diff, bits);
            if (!golomb) {
                rc->symbol(&p.state[size_t(context) * CONTEXT_SIZE], diff, true);
                continue;
            }
            if (context == 0) run_mode = 1;
            if (run_mode) {
                if (diff) {
                    while (run_count >= 1 << kLog2Run[run_index]) {
                        run_count -= 1 << kLog2Run[run_index];
                        run_index++;
                        bw->put(1, 1);
                    }
                    bw->put(1 + kLog2Run[run_index], uint32_t(run_count));
                    if (run_index) run_index--;
                    run_count = 0;
                    run_mode = 0;
                    if (diff > 0) diff--;
                } else {
                    run_count++;
                }
            }
            if (run_mode == 0) put_vlc_symbol(*bw, p.vlc[size_t(context)], diff, bits);
        }
        if (run_mode) {
            while (run_count >= 1 << kLog2Run[run_index]) {
                run_count -= 1 << kLog2Run[run_index];
                run_index++;
                bw->put(1, 1);
            }
            if (run_count) bw->put(1, 1);
        }
        s.run_index = run_index;
    }
};

// The planes of one slice, row by row.  RGB: per row G, B-G, R-G (and A),
// the differences offset by 256 and coded as 9-bit samples.  Grey: one
// plane of 8-bit samples.  Each plane has two line buffers of w + 6
// samples (coding starts at offset 3) that swap every row: the row above
// is read while the current one is written over the row two above, which
// five-input contexts read as TT.  The encoder loads a row from ``src``
// before coding it; the decoder stores it into ``frame`` (BGR) after.
template <bool DECODE, class Line>
void code_slice_planes(const Config& f, SliceCtx& s, Line& line, uint8_t* frame,
                       const uint8_t* src, int frame_w, int alpha_value) {
    const int w = s.w, h = s.h;
    const bool rgb = f.colorspace == 1;
    const int nplanes = rgb ? 3 + f.transparency : 1;
    const int stride = w + 6;
    s.rows.assign(size_t(2) * nplanes * stride, 0);
    s.run_index = 0;
    int* cur[4];
    int* top[4];
    for (int p = 0; p < nplanes; p++) {
        cur[p] = s.rows.data() + size_t(2 * p) * stride + 3;
        top[p] = s.rows.data() + size_t(2 * p + 1) * stride + 3;
    }
    for (int y = 0; y < h; y++) {
        for (int p = 0; p < nplanes; p++) std::swap(cur[p], top[p]);
        if (!DECODE) {   // load the row into cur
            for (int x = 0; x < w; x++) {
                if (rgb) {
                    const uint8_t* px = src + (size_t(s.y + y) * frame_w + s.x + x) * 3;
                    int b = px[0], g = px[1], r = px[2];
                    b -= g;
                    r -= g;
                    g += (b + r) >> 2;
                    cur[0][x] = g;
                    cur[1][x] = b + 256;
                    cur[2][x] = r + 256;
                    if (nplanes == 4) cur[3][x] = alpha_value;
                } else {
                    cur[0][x] = src[size_t(s.y + y) * frame_w + s.x + x];
                }
            }
        }
        for (int p = 0; p < nplanes; p++) {
            cur[p][-1] = top[p][0];
            top[p][w] = top[p][w - 1];
            const int set = rgb ? (p + 1) / 2 : 0;
            line.line(f, s, s.planes[set], w, cur[p], top[p], rgb ? 9 : 8);
        }
        if (DECODE) {
            for (int x = 0; x < w; x++) {
                uint8_t* px = frame + (size_t(s.y + y) * frame_w + s.x + x) * 3;
                if (rgb) {
                    int g = cur[0][x], b = cur[1][x] - 256, r = cur[2][x] - 256;
                    g -= (b + r) >> 2;
                    b += g;
                    r += g;
                    px[0] = uint8_t(b);
                    px[1] = uint8_t(g);
                    px[2] = uint8_t(r);
                } else {
                    px[0] = px[1] = px[2] = uint8_t(cur[0][x]);
                }
            }
        }
    }
}

template <class Fn>
void run_slices(int n, Fn fn) {
    std::vector<std::string> errors(static_cast<size_t>(n));
    auto guarded = [&](int i) {
        try {
            fn(i);
        } catch (const std::exception& e) {
            errors[size_t(i)] = e.what();
        }
    };
    if (n == 1) {
        guarded(0);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(size_t(n));
        for (int i = 0; i < n; i++) threads.emplace_back(guarded, i);
        for (auto& t : threads) t.join();
    }
    for (int i = 0; i < n; i++)
        if (!errors[size_t(i)].empty()) throw Error(errors[size_t(i)]);
}

// --------------------------------------------------------------- decoder
struct Decoder {
    Config f;
    int width, height;
    long frame_index = 0;
    bool key_seen = false;
    int slice_count = 0;
    std::vector<SliceCtx> slices;

    Decoder(const uint8_t* extra, size_t size, int w, int h) : width(w), height(h) {
        if (w < 1 || h < 1) throw Error("FFV1 frame size must be positive");
        parse_config(extra, size, w, h, f);
    }

    void read_v2_header(RangeDecoder& c) {
        uint8_t state[CONTEXT_SIZE];
        std::memset(state, 128, sizeof state);
        const int n = c.symbol(state, false);
        if (n < 1 || n > MAX_SLICES) throw Error("FFV1 slice count out of range");
        slice_count = n;
        slices.assign(size_t(n), SliceCtx());
        for (auto& s : slices) {
            s.sx = c.symbol(state, false);
            s.sy = c.symbol(state, false);
            const int sw = c.symbol(state, false) + 1, sh = c.symbol(state, false) + 1;
            place(s, sw, sh);
            for (int i = 0; i < f.plane_count() && i < MAX_PLANE_SETS; i++)
                set_quant(s.planes[i], c.symbol(state, false), true);
        }
    }

    void place(SliceCtx& s, int sw, int sh) {
        if (s.sx < 0 || s.sy < 0 || sw < 1 || sh < 1 || s.sx > f.num_h_slices - sw ||
            s.sy > f.num_v_slices - sh)
            throw Error("FFV1 slice position out of range");
        s.x = slice_coord(width, s.sx, f.num_h_slices);
        s.y = slice_coord(height, s.sy, f.num_v_slices);
        s.w = slice_coord(width, s.sx + sw, f.num_h_slices) - s.x;
        s.h = slice_coord(height, s.sy + sh, f.num_v_slices) - s.y;
        if (s.w < 1 || s.h < 1) throw Error("FFV1 empty slice");
    }

    void set_quant(PlaneCtx& p, int idx, bool key) {
        if (idx < 0 || idx >= f.quant_table_count)
            throw Error("FFV1 quantisation table index out of range");
        if (!key && idx != p.quant_index)
            throw Error("FFV1 quantisation table changed outside a keyframe");
        p.quant_index = idx;
    }

    bool decode(const uint8_t* pkt, size_t size, uint8_t* out) {
        const long fi = frame_index++;
        try {
            return decode_frame(pkt, size, out);
        } catch (const Error& e) {
            key_seen = false;   // states are unknown until the next keyframe
            throw Error(fmt("frame %ld: ", fi) + e.what());
        }
    }

    bool decode_frame(const uint8_t* pkt, size_t size, uint8_t* out) {
        if (size < 2) throw Error("empty packet");
        RangeDecoder c0;
        c0.init(pkt, size);
        uint8_t keystate = 128;
        const bool key = c0.bit(&keystate);
        if (!key && !key_seen) throw Error("no keyframe before this frame");
        if (key && f.version == 2) read_v2_header(c0);
        const int trailer = 3 + 5 * (f.ec ? 1 : 0);
        if (f.version > 2) {   // count the slices from the end
            int n = 0;
            const uint8_t* p = pkt + size;
            while (n < MAX_SLICES && p - pkt > trailer) {
                const long len = long(get_be24(p - trailer)) + trailer;
                if (len > p - pkt) break;
                p -= len;
                n++;
            }
            if (p != pkt || n == 0) throw Error("slice sizes do not add up to the packet");
            if (key) {
                slice_count = n;
                slices.assign(size_t(n), SliceCtx());
            } else if (n != slice_count) {
                throw Error("slice count changed outside a keyframe");
            }
        }
        std::vector<const uint8_t*> begin(static_cast<size_t>(slice_count));
        std::vector<size_t> len(static_cast<size_t>(slice_count));
        const uint8_t* p = pkt + size;
        for (int i = slice_count - 1; i >= 0; i--) {
            size_t v;
            if (i || f.version > 2) {
                if (p - pkt < trailer) throw Error("slice pointer chain broken");
                v = get_be24(p - trailer) + size_t(trailer);
            } else {
                v = size_t(p - pkt);
            }
            if (size_t(p - pkt) < v) throw Error("slice pointer chain broken");
            p -= v;
            if (f.ec && crc32(p, v) != 0) throw Error(fmt("slice %ld: CRC mismatch", i));
            begin[size_t(i)] = p;
            len[size_t(i)] = v;
        }
        run_slices(slice_count, [&](int i) {
            try {
                decode_slice(i, i ? nullptr : &c0, begin[size_t(i)], len[size_t(i)], key, out);
            } catch (const Error& e) {
                throw Error(fmt("slice %ld: ", i) + e.what());
            }
        });
        key_seen = true;
        return key;
    }

    void decode_slice(int i, RangeDecoder* first, const uint8_t* data, size_t size, bool key,
                      uint8_t* out) {
        SliceCtx& s = slices[size_t(i)];
        RangeDecoder c;
        if (first) {
            c = *first;
            c.end = data + size;
        } else {
            c.init(data, size);
        }
        c.tab = &f.states;
        if (f.version > 2) {
            uint8_t state[CONTEXT_SIZE];
            std::memset(state, 128, sizeof state);
            s.sx = c.symbol(state, false);
            s.sy = c.symbol(state, false);
            const int sw = c.symbol(state, false) + 1, sh = c.symbol(state, false) + 1;
            place(s, sw, sh);
            for (int p = 0; p < f.plane_count(); p++) {
                const int idx = c.symbol(state, false);
                if (p < MAX_PLANE_SETS) set_quant(s.planes[p], idx, key);
            }
            c.symbol(state, false);   // picture structure
            c.symbol(state, false);   // sample aspect ratio
            c.symbol(state, false);
        }
        if (key)
            for (int p = 0; p < std::min(f.plane_count(), MAX_PLANE_SETS); p++)
                s.planes[p].reset(f);
        BitReader br;
        if (!f.coder) {
            if (f.version > 2 && f.micro_version > 1) {
                uint8_t st = 129;
                c.bit(&st);
            }
            size_t skip = (f.version > 2 || (!s.x && !s.y)) ? size_t(c.pos - c.start - 1) : 0;
            if (skip > size_t(c.end - c.start)) throw Error("slice header overruns the slice");
            br.init(c.start + skip, c.end);
        }
        LineDecoder line{&c, &br, f.coder == 0};
        code_slice_planes<true>(f, s, line, out, nullptr, width, 0);
        if (f.coder && f.version > 2) {
            uint8_t st = 129;
            c.bit(&st);
            const long left = long(c.end - c.pos) - 2 - 5 * (f.ec ? 1 : 0);
            if (left) throw Error(fmt("range-coded data ends %ld bytes from the slice end", left));
        }
    }
};

// --------------------------------------------------------------- encoder
struct Encoder {
    Config f;
    int width, height, gop, alpha_value = 255;
    long frame_index = 0;
    std::vector<SliceCtx> slices;
    std::vector<uint8_t> extradata, packet;

    Encoder(int w, int h, int is_color, int version, int coder, int nh, int nv, int gop_,
            int alpha, int initial_states)
        : width(w), height(h), gop(gop_) {
        if (w < 1 || h < 1) throw Error("FFV1 frame size must be positive");
        if (version != 2 && version != 3) throw Error("FFV1 encoder writes versions 2 and 3");
        if (coder < 0 || coder > 2) throw Error("FFV1 coder must be 0, 1 or 2");
        if (nh < 1 || nv < 1 || nh > w || nv > h || nh * nv > MAX_SLICES)
            throw Error("FFV1 slice grid does not fit the frame");
        if (gop < 1) throw Error("FFV1 keyframe interval must be positive");
        f.version = version;
        f.micro_version = version > 2 ? 4 : 0;
        f.coder = coder;
        f.colorspace = is_color ? 1 : 0;
        f.bits = 8;
        f.chroma_planes = is_color ? 1 : 0;
        f.transparency = is_color && alpha ? 1 : 0;
        f.num_h_slices = nh;
        f.num_v_slices = nv;
        f.ec = version > 2 ? 1 : 0;
        f.intra = gop < 2 ? 1 : 0;
        f.quant_table_count = 2;
        default_quant_tables(f.quant);
        if (coder == 2) {   // a table of our own: each step one state further
            for (int i = 1; i < 256; i++) {
                int st = kDefaultStates.one[i] ? kDefaultStates.one[i] + 1 : i + 1;
                f.transition[i] = uint8_t(std::min(st, 255));
            }
            f.states = custom_states(f.transition);
        }
        if (initial_states && coder) {   // range-coder states that start
            for (int i = 0; i < f.quant_table_count; i++) {   // off 128
                const size_t n = size_t(f.quant[i].context_count) * CONTEXT_SIZE;
                f.initial_states[i].resize(n);
                for (size_t j = 0; j < n; j++)   // within the default table's
                    f.initial_states[i][j] = uint8_t(8 + (j * 37) % 241);   // 8..248
            }
        }
        extradata = write_config(f);
        slices.assign(size_t(nh * nv), SliceCtx());
        for (int i = 0; i < nh * nv; i++) {
            SliceCtx& s = slices[size_t(i)];
            s.sx = i % nh;
            s.sy = i / nh;
            s.x = slice_coord(w, s.sx, nh);
            s.y = slice_coord(h, s.sy, nv);
            s.w = slice_coord(w, s.sx + 1, nh) - s.x;
            s.h = slice_coord(h, s.sy + 1, nv) - s.y;
            for (int p = 0; p < MAX_PLANE_SETS; p++) s.planes[p].quant_index = 0;
        }
    }

    // Codes one frame; returns whether it is a keyframe.
    bool encode(const uint8_t* src, std::vector<uint8_t>& out) {
        const bool key = frame_index++ % gop == 0;
        const int n = int(slices.size());
        std::vector<std::vector<uint8_t>> bufs(static_cast<size_t>(n));
        run_slices(n, [&](int i) { encode_slice(i, key, src, bufs[size_t(i)]); });
        out.clear();
        for (auto& b : bufs) out.insert(out.end(), b.begin(), b.end());
        return key;
    }

    void encode_slice(int i, bool key, const uint8_t* src, std::vector<uint8_t>& out) {
        SliceCtx& s = slices[size_t(i)];
        RangeEncoder c;
        c.out.reserve(size_t(s.w) * s.h * (f.colorspace ? 4 : 1) * 2 + 64);
        if (i == 0) {
            uint8_t keystate = 128;
            c.bit(&keystate, key);
            if (key && f.version == 2) {
                uint8_t state[CONTEXT_SIZE];
                std::memset(state, 128, sizeof state);
                c.symbol(state, int(slices.size()), false);
                for (auto& o : slices) {
                    c.symbol(state, o.sx, false);
                    c.symbol(state, o.sy, false);
                    c.symbol(state, 0, false);
                    c.symbol(state, 0, false);
                    for (int p = 0; p < f.plane_count(); p++) c.symbol(state, 0, false);
                }
            }
        }
        c.tab = &f.states;
        if (key)
            for (int p = 0; p < std::min(f.plane_count(), MAX_PLANE_SETS); p++)
                s.planes[p].reset(f);
        if (f.version > 2) {
            uint8_t state[CONTEXT_SIZE];
            std::memset(state, 128, sizeof state);
            c.symbol(state, s.sx, false);
            c.symbol(state, s.sy, false);
            c.symbol(state, 0, false);
            c.symbol(state, 0, false);
            for (int p = 0; p < f.plane_count(); p++) c.symbol(state, 0, false);
            c.symbol(state, 3, false);   // progressive
            c.symbol(state, 0, false);   // sample aspect ratio unknown
            c.symbol(state, 1, false);
        }
        if (f.coder == 0) {
            // version 2 ends slice 0's range-coded frame header without a
            // marker, so its end is placed once the first Golomb-Rice byte
            // is known
            const bool header = f.version == 2 && i == 0;
            if (f.version > 2) c.terminate(true);
            std::vector<uint8_t> bits;
            BitWriter bw(header ? &bits : &c.out);
            LineEncoder line{nullptr, &bw, true};
            code_slice_planes<false>(f, s, line, nullptr, src, width, alpha_value);
            bw.flush();
            if (header) {
                c.terminate(false, bits[0]);
                c.out.insert(c.out.end(), bits.begin(), bits.end());
            }
            out = std::move(c.out);
        } else {
            LineEncoder line{&c, nullptr, false};
            code_slice_planes<false>(f, s, line, nullptr, src, width, alpha_value);
            c.terminate(true);
            out = std::move(c.out);
        }
        const size_t bytes = out.size();
        if (bytes >= (1u << 24)) throw Error("FFV1 slice larger than 16 MiB");
        if (i > 0 || f.version > 2) put_be(out, uint32_t(bytes), 3);
        if (f.ec) {
            out.push_back(0);   // error status
            put_be(out, crc32(out.data(), out.size()), 4);
        }
    }
};

thread_local std::string last_error;

int fail(const std::exception& e) {
    last_error = e.what();
    return -1;
}

}  // namespace

extern "C" {

// The message of the last failed call on this thread.
const char* ffv1_last_error() { return last_error.c_str(); }

// A decoder for a stream with configuration record ``extra`` (the AVI
// stream format's bytes after BITMAPINFOHEADER) and frames of w x h.
// Null on error.
void* ffv1_decoder_new(const uint8_t* extra, long size, int w, int h) {
    try {
        return new Decoder(extra, size_t(size), w, h);
    } catch (const std::exception& e) {
        fail(e);
        return nullptr;
    }
}

// version, micro_version, coder, colorspace, bits, transparency,
// num_h_slices, num_v_slices, ec, quant_table_count
void ffv1_decoder_info(void* d, int* out) {
    const Config& f = static_cast<Decoder*>(d)->f;
    const int v[] = {f.version,      f.micro_version, f.coder,        f.colorspace,
                     f.bits,         f.transparency,  f.num_h_slices, f.num_v_slices,
                     f.ec,           f.quant_table_count};
    std::memcpy(out, v, sizeof v);
}

// Decodes one frame into ``out`` (h x w x 3 BGR).  Returns 1 for a
// keyframe, 0 for another frame, -1 on error (no pixels are valid then).
int ffv1_decode(void* d, const uint8_t* pkt, long size, uint8_t* out) {
    try {
        return static_cast<Decoder*>(d)->decode(pkt, size_t(size), out);
    } catch (const std::exception& e) {
        return fail(e);
    }
}

void ffv1_decoder_free(void* d) { delete static_cast<Decoder*>(d); }

// An encoder of w x h frames: BGR (is_color) or grey, FFV1 ``version`` 2
// or 3, ``coder`` 0 (Golomb-Rice), 1 (range, default states) or 2 (range,
// custom state table), an nh x nv slice grid, a keyframe every ``gop``
// frames, an alpha plane (of 255) when ``alpha`` and is_color, and with a
// range coder, context states that start from the record's own values
// when ``initial_states``.  Null on error.
void* ffv1_encoder_new(int w, int h, int is_color, int version, int coder, int nh, int nv,
                       int gop, int alpha, int initial_states) {
    try {
        return new Encoder(w, h, is_color, version, coder, nh, nv, gop, alpha,
                           initial_states);
    } catch (const std::exception& e) {
        fail(e);
        return nullptr;
    }
}

// The configuration record: copies up to ``cap`` bytes, returns its size.
long ffv1_encoder_extradata(void* e, uint8_t* out, long cap) {
    const auto& x = static_cast<Encoder*>(e)->extradata;
    std::memcpy(out, x.data(), std::min(size_t(cap), x.size()));
    return long(x.size());
}

// Codes one frame (h x w x 3 BGR, or h x w grey) into the encoder's packet
// buffer, which ffv1_encoder_packet copies out.  Returns the packet's size
// and sets *key; -1 on error.
long ffv1_encode(void* e, const uint8_t* frame, int* key) {
    Encoder* enc = static_cast<Encoder*>(e);
    try {
        *key = enc->encode(frame, enc->packet);
        return long(enc->packet.size());
    } catch (const std::exception& ex) {
        return fail(ex);
    }
}

void ffv1_encoder_packet(void* e, uint8_t* out) {
    const auto& p = static_cast<Encoder*>(e)->packet;
    std::memcpy(out, p.data(), p.size());
}

void ffv1_encoder_free(void* e) { delete static_cast<Encoder*>(e); }

}  // extern "C"
