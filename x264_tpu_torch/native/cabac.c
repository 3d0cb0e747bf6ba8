/* CABAC binary arithmetic encoder — the serial FSM tail of the entropy
 * coder. Direct transcription of the H.264 spec 9.3.4.3 encoder
 * flowcharts (EncodeDecision / RenormE / PutBit / EncodeBypass /
 * EncodeTerminate / EncodeFlush): carries are deferred through the
 * spec's bitsOutstanding counter, bits leave through an MSB-first
 * byte packer, and previously written bytes are never revisited.
 * (Role analogue: common/cabac.c:807-926 in the reference; the
 * byte-emission scheme here is the spec's own.)
 *
 * The TPU pipeline emits a *compacted, packed bin-operation stream*
 * (the parallel part); this engine consumes it sequentially at native
 * speed. Each op is one uint32:
 *     kind = op >> 29,  b = (op >> 17) & 0xFFF,  a = op & 0x1FFFF
 *   kind 0: decision         a = ctx index, b = bin
 *   kind 1: raw bypass bits  a = value, b = nbits (MSB first)
 *   kind 2: ue bypass        a = value, b = exp_bits (k-th exp-Golomb)
 *   kind 3: terminal(0)      (end_of_slice_flag = 0)
 *   kind 4: pad (ignored)
 *   kind 5: repeated 1-bins  a = ctx index, b = count (level prefixes)
 *   kind 6: residual sig map a = significance mask, b = cat | last<<3
 *   kind 7: residual level   a = |level|-1, b = sign
 * Kinds 6/7 expand the significance/last decisions and the coefficient
 * level binarization (block_residual_write_cabac semantics,
 * encoder/cabac.c:584) inside the engine, keeping the device stream
 * ~6x smaller. The final terminal(1) + flush is emitted at the end.
 */
#include <stdint.h>

typedef struct {
    uint32_t low;        /* codILow  */
    uint32_t range;      /* codIRange */
    int      first;      /* firstBitFlag */
    uint32_t pending;    /* bitsOutstanding */
    uint32_t bitbuf;     /* MSB-first bit accumulator */
    int      nbits;
    uint8_t *p;
} cab_t;

static void raw_bit(cab_t *c, int b)
{
    c->bitbuf = (c->bitbuf << 1) | (uint32_t)b;
    if (++c->nbits == 8) {
        *(c->p++) = (uint8_t)c->bitbuf;
        c->bitbuf = 0;
        c->nbits = 0;
    }
}

static void put_bit(cab_t *c, int b)
{
    if (c->first)
        c->first = 0;
    else
        raw_bit(c, b);
    while (c->pending) {
        raw_bit(c, b ^ 1);
        c->pending--;
    }
}

static void renorm(cab_t *c)
{
    while (c->range < 256) {
        if (c->low >= 512) {
            c->low -= 512;
            put_bit(c, 1);
        } else if (c->low < 256) {
            put_bit(c, 0);
        } else {
            c->low -= 256;
            c->pending++;
        }
        c->range <<= 1;
        c->low <<= 1;
    }
}

static void decision(cab_t *c, uint8_t *state,
                     const uint8_t *range_lps, const uint8_t *transition,
                     int ctx, int b)
{
    int s = state[ctx];
    uint32_t lps = range_lps[s * 4 + ((c->range >> 6) & 3)];
    c->range -= lps;
    if (b != (s >> 6)) {
        c->low += c->range;
        c->range = lps;
    }
    state[ctx] = transition[s * 2 + b];
    renorm(c);
}

static void bypass(cab_t *c, int b)
{
    c->low <<= 1;
    if (b)
        c->low += c->range;
    if (c->low >= 1024) {
        c->low -= 1024;
        put_bit(c, 1);
    } else if (c->low < 512) {
        put_bit(c, 0);
    } else {
        c->low -= 512;
        c->pending++;
    }
}

static void ue_bypass(cab_t *c, uint32_t val, int k)
{
    while (val >= (1u << k)) {
        bypass(c, 1);
        val -= 1u << k;
        k++;
    }
    bypass(c, 0);
    while (k > 0) {
        k--;
        bypass(c, (val >> k) & 1);
    }
}

/* residual tables (spec 9.3.3.1.1.9 / 9.3.2.6 constants, frame coding;
 * category 5 = luma 8x8, spec Table 9-43 ctxIdxMap for the shared
 * significance/last contexts) */
static const uint8_t  CAT_C_T[6]    = {16, 15, 16, 4, 15, 64};
static const uint16_t SIG_BASE_T[6] = {105, 120, 134, 149, 152, 402};
static const uint16_t LAST_BASE_T[6] = {166, 181, 195, 210, 213, 417};
static const uint16_t LVL_BASE_T[6] = {227, 237, 247, 257, 266, 426};
static const uint8_t  SIG_MAP8[63] = {
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9,10, 9, 8, 7,
    7, 6,11,12,13,11, 6, 7, 8, 9,14,10, 9, 8, 6,11,
   12,13,11, 6, 9,14,10, 9,11,12,13,11,14,10,12};
static const uint8_t  LAST_MAP8[63] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};
static const uint8_t  L1_CTX_T[8]   = {1, 2, 3, 4, 0, 0, 0, 0};
static const uint8_t  GT1_CTX_T[8]  = {5, 5, 5, 5, 6, 7, 8, 9};
static const uint8_t  TRN_T[2][8]   = {{1, 2, 3, 3, 4, 5, 6, 7},
                                       {4, 4, 4, 4, 5, 6, 7, 7}};

long cabac_encode(uint8_t *state,
                  const uint8_t *range_lps,   /* [128][4] */
                  const uint8_t *transition,  /* [128][2] */
                  const uint32_t *ops, long n,
                  uint8_t *out)
{
    cab_t c;
    long i;
    int cat = 0, node = 0;
    uint64_t sig_acc = 0;
    c.low = 0;
    c.range = 510;
    c.first = 1;
    c.pending = 0;
    c.bitbuf = 0;
    c.nbits = 0;
    c.p = out + 1;   /* out[0] = last slice-header byte, never modified */

    for (i = 0; i < n; i++) {
        uint32_t op = ops[i];
        int k = op >> 29;
        int b = (op >> 17) & 0xFFF;
        uint32_t a = op & 0x1FFFF;
        if (k == 0) {
            decision(&c, state, range_lps, transition, (int)a, b & 1);
        } else if (k == 7) {
            /* residual level: unary prefix / exp-Golomb suffix / sign */
            int prefix = a < 14 ? (int)a : 14;
            int base = LVL_BASE_T[cat];
            int j;
            decision(&c, state, range_lps, transition,
                     base + L1_CTX_T[node], prefix > 0);
            for (j = 0; j < prefix - 1; j++)
                decision(&c, state, range_lps, transition,
                         base + GT1_CTX_T[node], 1);
            if (prefix > 0 && prefix < 14)
                decision(&c, state, range_lps, transition,
                         base + GT1_CTX_T[node], 0);
            if (prefix >= 14)
                ue_bypass(&c, a - 14, 0);
            bypass(&c, b & 1);
            node = TRN_T[prefix > 0][node];
        } else if (k == 6) {
            /* residual significance map; resets the level machine.
             * cat 5 (luma 8x8) arrives as 4 mask parts (b[10:9]);
             * parts 0-2 only accumulate, part 3 (or any cat<5 op,
             * always part 0) emits. 8x8 sig/last contexts are shared
             * through the spec Table 9-43 maps. */
            int last = (b >> 3) & 63;
            int part = (b >> 9) & 3;
            int sz, j;
            cat = b & 7;
            if (cat == 5 && part < 3) {
                if (part == 0)
                    sig_acc = 0;
                sig_acc |= (uint64_t)a << (16 * part);
                continue;
            }
            if (cat == 5)
                sig_acc |= (uint64_t)a << 48;
            else
                sig_acc = a;
            node = 0;
            sz = CAT_C_T[cat] - 1;
            if (last + 1 < sz)
                sz = last + 1;
            for (j = 0; j < sz; j++) {
                int bit = (int)((sig_acc >> j) & 1);
                int co = cat == 5 ? SIG_MAP8[j] : j;
                int lo = cat == 5 ? LAST_MAP8[j] : j;
                decision(&c, state, range_lps, transition,
                         SIG_BASE_T[cat] + co, bit);
                if (bit)
                    decision(&c, state, range_lps, transition,
                             LAST_BASE_T[cat] + lo, j == last);
            }
            sig_acc = 0;
        } else if (k == 5) {
            int j;
            for (j = 0; j < b; j++)
                decision(&c, state, range_lps, transition, (int)a, 1);
        } else if (k == 1) {
            int j;
            for (j = b - 1; j >= 0; j--)
                bypass(&c, (a >> j) & 1);
        } else if (k == 2) {
            ue_bypass(&c, a, b);
        } else if (k == 3) {
            c.range -= 2;
            renorm(&c);
        } /* k == 4: pad */
    }

    /* EncodeTerminate(1) + EncodeFlush: the forced low bit of the
     * final 2 written bits is the rbsp stop bit; zero-pad to byte */
    c.low += c.range - 2;
    c.range = 2;
    renorm(&c);
    put_bit(&c, (c.low >> 9) & 1);
    raw_bit(&c, (c.low >> 8) & 1);
    raw_bit(&c, 1);
    while (c.nbits)
        raw_bit(&c, 0);
    return (long)(c.p - (out + 1));
}
