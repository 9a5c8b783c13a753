// AEGIS-128L in MAC mode — the framework checksum.
//
// Behavior contract (reference: src/vsr/checksum.zig): AEGIS-128L AEAD
// (draft-irtf-cfrg-aegis-aead) specialized to a MAC by using a zero key, zero
// nonce, empty secret message, and the bytes-to-sign as associated data; the
// 128-bit authentication tag is the checksum.  Implemented from the IETF
// draft's specification, hardware-accelerated with AES-NI when available.
//
// Exported C ABI (ctypes-consumed, see tigerbeetle_tpu/native/__init__.py):
//   tb_checksum(data, len, out16)          — one-shot checksum
//   tb_checksum_batch(data, n, stride, lens, out) — n checksums, SoA layout

#include <cstdint>
#include <cstring>
#include <mutex>
#include <cstddef>

#if defined(__AES__) && defined(__SSE2__)
#define TB_AESNI 1
#include <immintrin.h>
#else
#define TB_AESNI 0
#endif

namespace {

const uint8_t C0[16] = {0x00, 0x01, 0x01, 0x02, 0x03, 0x05, 0x08, 0x0d,
                        0x15, 0x22, 0x37, 0x59, 0x90, 0xe9, 0x79, 0x62};
const uint8_t C1[16] = {0xdb, 0x3d, 0x18, 0x55, 0x6d, 0xc2, 0x2f, 0xf1,
                        0x20, 0x11, 0x31, 0x42, 0x73, 0xb5, 0x28, 0xdd};

#if TB_AESNI

struct State {
    __m128i s[8];
};

// S'i = AESRound(S[i-1], S[i]); the message XORs into the round-key operand:
// S'0 = AESRound(S7, S0 ^ M0), S'4 = AESRound(S3, S4 ^ M1).
static inline void update(State &st, __m128i m0, __m128i m1) {
    __m128i t7 = st.s[7];
    st.s[7] = _mm_aesenc_si128(st.s[6], st.s[7]);
    st.s[6] = _mm_aesenc_si128(st.s[5], st.s[6]);
    st.s[5] = _mm_aesenc_si128(st.s[4], st.s[5]);
    st.s[4] = _mm_aesenc_si128(st.s[3], _mm_xor_si128(st.s[4], m1));
    st.s[3] = _mm_aesenc_si128(st.s[2], st.s[3]);
    st.s[2] = _mm_aesenc_si128(st.s[1], st.s[2]);
    st.s[1] = _mm_aesenc_si128(st.s[0], st.s[1]);
    st.s[0] = _mm_aesenc_si128(t7, _mm_xor_si128(st.s[0], m0));
}

static inline State init_zero_key() {
    const __m128i zero = _mm_setzero_si128();
    const __m128i c0 = _mm_loadu_si128((const __m128i *)C0);
    const __m128i c1 = _mm_loadu_si128((const __m128i *)C1);
    State st;
    st.s[0] = zero;  // key ^ nonce
    st.s[1] = c1;
    st.s[2] = c0;
    st.s[3] = c1;
    st.s[4] = zero;  // key ^ nonce
    st.s[5] = c0;    // key ^ C0
    st.s[6] = c1;    // key ^ C1
    st.s[7] = c0;    // key ^ C0
    for (int i = 0; i < 10; i++) update(st, zero, zero);  // Update(nonce, key)
    return st;
}

static void checksum_impl(const uint8_t *data, size_t len, uint8_t out[16]) {
    State st = init_zero_key();
    size_t full = len / 32;
    for (size_t i = 0; i < full; i++) {
        __m128i m0 = _mm_loadu_si128((const __m128i *)(data + 32 * i));
        __m128i m1 = _mm_loadu_si128((const __m128i *)(data + 32 * i + 16));
        update(st, m0, m1);
    }
    size_t rem = len % 32;
    if (rem) {
        uint8_t pad[32] = {0};
        std::memcpy(pad, data + 32 * full, rem);
        __m128i m0 = _mm_loadu_si128((const __m128i *)pad);
        __m128i m1 = _mm_loadu_si128((const __m128i *)(pad + 16));
        update(st, m0, m1);
    }
    // Finalize: tmp = S2 ^ (LE64(ad_len_bits) || LE64(msg_len_bits=0)).
    uint64_t lens[2] = {(uint64_t)len * 8, 0};
    __m128i tmp = _mm_xor_si128(st.s[2], _mm_loadu_si128((const __m128i *)lens));
    for (int i = 0; i < 7; i++) update(st, tmp, tmp);
    __m128i tag = _mm_xor_si128(st.s[0], st.s[1]);
    tag = _mm_xor_si128(tag, st.s[2]);
    tag = _mm_xor_si128(tag, st.s[3]);
    tag = _mm_xor_si128(tag, st.s[4]);
    tag = _mm_xor_si128(tag, st.s[5]);
    tag = _mm_xor_si128(tag, st.s[6]);
    _mm_storeu_si128((__m128i *)out, tag);
}

#else  // portable fallback: table-based AES round

static uint8_t SBOX[256];
static uint32_t T0[256], T1[256], T2[256], T3[256];
static std::once_flag tables_once;

static uint8_t xtime(uint8_t x) { return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b)); }

// ctypes drops the GIL during foreign calls, so first use may race: call_once.
static void init_tables_impl() {
    // Generate the AES S-box (multiplicative inverse in GF(2^8) + affine map).
    uint8_t p = 1, q = 1;
    SBOX[0] = 0x63;
    do {
        p = (uint8_t)(p ^ (p << 1) ^ ((p & 0x80) ? 0x1b : 0));
        q ^= (uint8_t)(q << 1);
        q ^= (uint8_t)(q << 2);
        q ^= (uint8_t)(q << 4);
        if (q & 0x80) q ^= 0x09;
        SBOX[p] = (uint8_t)(q ^ (uint8_t)((q << 1) | (q >> 7)) ^
                            (uint8_t)((q << 2) | (q >> 6)) ^
                            (uint8_t)((q << 3) | (q >> 5)) ^
                            (uint8_t)((q << 4) | (q >> 4)) ^ 0x63);
    } while (p != 1);
    for (int i = 0; i < 256; i++) {
        uint8_t s = SBOX[i];
        uint8_t s2 = xtime(s);
        uint8_t s3 = (uint8_t)(s2 ^ s);
        T0[i] = (uint32_t)s2 | ((uint32_t)s << 8) | ((uint32_t)s << 16) |
                ((uint32_t)s3 << 24);
        T1[i] = (T0[i] << 8) | (T0[i] >> 24);
        T2[i] = (T1[i] << 8) | (T1[i] >> 24);
        T3[i] = (T2[i] << 8) | (T2[i] >> 24);
    }
}

static void init_tables() { std::call_once(tables_once, init_tables_impl); }

struct Block {
    uint32_t w[4];  // little-endian columns
};

// One AES round (SubBytes+ShiftRows+MixColumns+AddRoundKey(rk)) on `a`.
static inline Block aesround(const Block &a, const Block &rk) {
    Block r;
    r.w[0] = T0[a.w[0] & 0xff] ^ T1[(a.w[1] >> 8) & 0xff] ^
             T2[(a.w[2] >> 16) & 0xff] ^ T3[(a.w[3] >> 24) & 0xff] ^ rk.w[0];
    r.w[1] = T0[a.w[1] & 0xff] ^ T1[(a.w[2] >> 8) & 0xff] ^
             T2[(a.w[3] >> 16) & 0xff] ^ T3[(a.w[0] >> 24) & 0xff] ^ rk.w[1];
    r.w[2] = T0[a.w[2] & 0xff] ^ T1[(a.w[3] >> 8) & 0xff] ^
             T2[(a.w[0] >> 16) & 0xff] ^ T3[(a.w[1] >> 24) & 0xff] ^ rk.w[2];
    r.w[3] = T0[a.w[3] & 0xff] ^ T1[(a.w[0] >> 8) & 0xff] ^
             T2[(a.w[1] >> 16) & 0xff] ^ T3[(a.w[2] >> 24) & 0xff] ^ rk.w[3];
    return r;
}

static inline Block bxor(const Block &a, const Block &b) {
    Block r;
    for (int i = 0; i < 4; i++) r.w[i] = a.w[i] ^ b.w[i];
    return r;
}

static inline Block load(const uint8_t *p) {
    Block b;
    std::memcpy(b.w, p, 16);
    return b;
}

struct State {
    Block s[8];
};

static inline void update(State &st, const Block &m0, const Block &m1) {
    Block t7 = st.s[7];
    st.s[7] = aesround(st.s[6], st.s[7]);
    st.s[6] = aesround(st.s[5], st.s[6]);
    st.s[5] = aesround(st.s[4], st.s[5]);
    st.s[4] = aesround(st.s[3], bxor(st.s[4], m1));
    st.s[3] = aesround(st.s[2], st.s[3]);
    st.s[2] = aesround(st.s[1], st.s[2]);
    st.s[1] = aesround(st.s[0], st.s[1]);
    st.s[0] = aesround(t7, bxor(st.s[0], m0));
}

static void checksum_impl(const uint8_t *data, size_t len, uint8_t out[16]) {
    init_tables();
    Block zero = {{0, 0, 0, 0}};
    State st;
    st.s[0] = zero;
    st.s[1] = load(C1);
    st.s[2] = load(C0);
    st.s[3] = load(C1);
    st.s[4] = zero;
    st.s[5] = load(C0);
    st.s[6] = load(C1);
    st.s[7] = load(C0);
    for (int i = 0; i < 10; i++) update(st, zero, zero);

    size_t full = len / 32;
    for (size_t i = 0; i < full; i++) {
        update(st, load(data + 32 * i), load(data + 32 * i + 16));
    }
    size_t rem = len % 32;
    if (rem) {
        uint8_t pad[32] = {0};
        std::memcpy(pad, data + 32 * full, rem);
        update(st, load(pad), load(pad + 16));
    }
    uint64_t lens[2] = {(uint64_t)len * 8, 0};
    Block tmp = bxor(st.s[2], load((const uint8_t *)lens));
    for (int i = 0; i < 7; i++) update(st, tmp, tmp);
    Block tag = st.s[0];
    for (int i = 1; i < 7; i++) tag = bxor(tag, st.s[i]);
    std::memcpy(out, tag.w, 16);
}

#endif  // TB_AESNI

}  // namespace

extern "C" {

void tb_checksum(const uint8_t *data, uint64_t len, uint8_t *out16) {
    checksum_impl(data, (size_t)len, out16);
}

// n independent checksums: input i is data[i*stride .. i*stride+lens[i]],
// output i is out[i*16..]. Used to checksum WAL sectors / batched messages.
void tb_checksum_batch(const uint8_t *data, uint64_t n, uint64_t stride,
                       const uint64_t *lens, uint8_t *out) {
    for (uint64_t i = 0; i < n; i++) {
        checksum_impl(data + i * stride, (size_t)lens[i], out + i * 16);
    }
}

int tb_aesni_enabled(void) { return TB_AESNI; }

}  // extern "C"
