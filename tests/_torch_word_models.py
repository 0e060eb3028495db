"""What the port's kernel tests share: numpy models of the word arithmetic
of K1 and K2 (csrc/rle_kernels.cu), written with SIMD-within-a-word
operations on uint32 arrays as CUDA defines them, and the seeded text
planes of the VCFC_PARSE=device route.

tests/test_torch_rle.py holds the K1/K2 models to the plain versions;
tests/test_torch_text_words.py builds K3's and K4's models on them;
tests/test_torch_text.py and tests/test_torch_text_words.py run the text
planes.
"""

import numpy as np

from vcfc_tpu.ops.pallas_rle import _block_l

# SIMD-within-a-word operations on uint32 arrays, as CUDA defines them
U = np.uint32


def u(x):
    return np.asarray(x, dtype=np.int64).astype(U)


def to_bytes(x):
    return np.ascontiguousarray(u(x)).view(np.uint8).reshape(np.shape(x) + (4,))


def to_word(b):
    return np.ascontiguousarray(b.astype(np.uint8)).view(U).reshape(b.shape[:-1])


def byte_perm(x, y, s):
    x, y, s = np.broadcast_arrays(u(x), u(y), u(s))
    src = np.concatenate([to_bytes(x), to_bytes(y)], axis=-1)
    sel = np.stack([(s >> U(4 * i)) & U(7) for i in range(4)], axis=-1).astype(np.intp)
    return to_word(np.take_along_axis(src, sel, axis=-1))


def below(t):
    t = np.asarray(t, np.int64)
    return u(np.where(t <= 0, 0, np.where(t >= 32, 0xFFFFFFFF, (1 << np.clip(t, 0, 31)) - 1)))


MSBS, LOW7 = U(0x80808080), U(0x7F7F7F7F)


def nonzero(t):
    return (((t & LOW7) + LOW7) | t) & MSBS


def byte_msbs(s):
    return (s * U(0x00204081)) >> U(28)


def msbs_to_bytes(s):
    return (s >> U(7)) * U(0xFF)


def funnelshift_l(lo, hi, shift):
    return (hi << U(shift)) | (lo >> U(32 - shift))


def bits_to_bytes(b):
    return (((b & U(0xF)) * U(0x00204081)) & U(0x01010101)) * U(0xFF)


def nibbles(m):
    t = m | (m >> U(4))
    return (t & U(0xFF)) | ((t >> U(8)) & U(0xFF00))


def splat(b):
    return u(b) * U(0x01010101)


def bit(mask, k):
    return (mask >> U(k)) & U(1)


def popc(mask):
    return sum(bit(mask, k).astype(np.int64) for k in range(32))


def group_words(plane, p0):
    """The 16 cells at p0 of every row as four words; 0 past the width."""
    group = np.zeros((plane.shape[0], 16), np.uint8)
    cut = plane[:, p0 : p0 + 16]
    group[:, : cut.shape[1]] = cut
    return [to_word(group[:, 4 * j : 4 * j + 4]) for j in range(4)]


def k1_word_model(codes, n):
    """K1's group arithmetic (rle_encode_rows_kernel), group by group left
    to right over all rows at once; the warp scan is the running max."""
    L, W = codes.shape
    end = min(n, W)
    flags = np.zeros((L, W), np.uint8)
    count = np.zeros(L, np.int64)
    carry = np.full(L, -1, np.int64)
    for p0 in range(0, W, 16):
        x = group_words(codes, p0)
        prev = codes[:, p0 - 1].astype(np.int64) if p0 > 0 else None
        S = np.zeros(L, U)
        word_before = u(prev) << U(24) if prev is not None else np.zeros(L, U)
        esc_before = u(np.where(prev == 4, 0x80000000, 0)) if prev is not None else np.zeros(L, U)
        for j in range(4):
            esc = nonzero(x[j] ^ splat(4)) ^ MSBS
            s = (nonzero(x[j] ^ funnelshift_l(word_before, x[j], 8)) | esc
                 | funnelshift_l(esc_before, esc, 8))
            S |= byte_msbs(s) << U(4 * j)
            word_before, esc_before = x[j], esc
        if prev is None:
            S |= U(1)
        if p0 + 16 < W:
            nxt, last_code = codes[:, p0 + 16].astype(np.int64), (x[3] >> U(24)).astype(np.int64)
            S |= np.where((nxt != last_code) | (nxt == 4) | (last_code == 4), U(1 << 16), U(0))
        S &= below(W - p0)
        own = (S & U(0xFFFF)).astype(np.int64)
        hb = np.full(L, -1, np.int64)
        for k in range(16):
            hb = np.where((own >> k) & 1, k, hb)
        run_start = carry
        carry = np.maximum(carry, np.where(own > 0, p0 + hb, -1))
        c0 = (x[0] & U(0xFF)).astype(np.int64)
        cap0 = np.where(c0 == 0, 127, 31)
        d0 = np.where(bit(S, 0) > 0, 0, p0 - run_start)
        rem0 = np.where(c0 == 0, d0 % 127, d0 % 31)
        B = S.copy()
        wrap = np.where(rem0 == 0, 0, cap0 - rem0)
        ok = (wrap <= 16) & ((S & below(wrap)) == 0)
        B |= np.where(ok, u(1) << u(np.minimum(wrap, 16)), U(0))
        B &= below(W - p0)
        count += popc(B & below(min(end - p0, 16)))
        Lm = (B >> U(1)) & below(end - p0 - 1)
        if n > p0 and n - p0 <= 16 and n <= W:
            Lm |= U(1 << (n - 1 - p0))
        F_in, seen_in = np.zeros(L, U), np.zeros(L, U)
        f = []
        for j in range(4):
            k1 = U(0x04030201) + splat(4 * j)
            seen = bits_to_bytes(B >> U(4 * j))
            F = k1 & seen
            F |= ~seen & (F << U(8))
            seen |= seen << U(8)
            F |= ~seen & (F << U(16))
            seen |= seen << U(16)
            F |= ~seen & F_in
            seen |= seen_in
            F_in = byte_perm(F, 0, 0x3333)
            seen_in = u(np.where(seen >> U(31), 0xFFFFFFFF, 0))
            rem = (seen & (k1 - F)) | (~seen & (splat(rem0) + k1 - splat(1)))
            low = byte_perm(0x80C0A000, 0, nibbles(x[j] & splat(3)))
            high = msbs_to_bytes(nonzero(x[j] & splat(0xFC)))
            base = (low & ~high) | (high & splat(0xE0))
            f.append((base | (rem + splat(1))) & bits_to_bytes(Lm >> U(4 * j)))
        out = np.stack([to_bytes(w) for w in f], axis=1).reshape(L, 16)
        flags[:, p0 : p0 + 16] = out[:, : min(16, W - p0)]
    return flags, count.astype(np.int32)


def k2_word_model(flags, n):
    """K2's group arithmetic (rle_decode_rows_kernel), group by group right
    to left over all rows at once."""
    L, W = flags.shape
    end = min(n, W)
    codes = np.zeros((L, W), np.uint8)
    total = np.zeros(L, np.int64)
    carry = np.full(L, 4, np.int64)
    for p0 in range((W - 1) // 16 * 16, -1, -16):
        x = group_words(flags, p0)
        P = np.zeros(L, U)
        for j in range(4):
            P |= byte_msbs(nonzero(x[j])) << U(4 * j)
        in_code = carry
        first = np.full(L, -1, np.int64)
        for k in range(15, -1, -1):
            word = x[k // 4]
            code = byte_perm(0, 0x04020103, (word >> U(8 * (k % 4) + 5)) & U(7)) & U(0xFF)
            first = np.where(bit(P, k) > 0, code.astype(np.int64), first)
        carry = np.where(first >= 0, first, carry)
        fill = u(in_code)
        c = [None] * 4
        for j in range(3, -1, -1):
            known = msbs_to_bytes(nonzero(x[j]))
            v = byte_perm(0, 0x04020103, nibbles((x[j] >> U(5)) & U(0x07070707))) & known
            v |= ~known & (v >> U(8))
            known |= known >> U(8)
            v |= ~known & (v >> U(16))
            known |= known >> U(16)
            c[j] = v | (~known & splat(fill))
            fill = c[j] & U(0xFF)
        below_n = end - p0
        halves = np.zeros(L, U)
        for j in range(4 if below_n > 0 else 0):
            hi = msbs_to_bytes(x[j] & MSBS)
            esc = msbs_to_bytes(x[j] & (x[j] << U(1)) & (x[j] << U(2)) & MSBS)
            run_len = x[j] & (LOW7 ^ (hi & splat(0x60)))
            run_len = (run_len & ~esc) | (esc & splat(1))
            if below_n < 16:
                run_len &= bits_to_bytes(below(below_n) >> U(4 * j))
            halves += (run_len & U(0x00FF00FF)) + ((run_len >> U(8)) & U(0x00FF00FF))
        total += ((halves & U(0xFFFF)) + (halves >> U(16))).astype(np.int64)
        out = np.stack([to_bytes(w) for w in c], axis=1).reshape(L, 16)
        codes[:, p0 : p0 + 16] = out[:, : min(16, W - p0)]
    return codes, total.astype(np.int32)


# The text planes
FIELDS = [b"0|0", b"0|1", b"1|0", b"1|1", b"2|0", b"./.", b"0/1", b"9|9"]
PICK = [0.7, 0.08, 0.08, 0.06, 0.03, 0.03, 0.01, 0.01]


def text_words(rng, L, S, S_pad):
    """(L, S_pad) int32 words of random genotype fields: tab separators,
    '\\n' on sample S - 1 (as test_pallas's _words), zero padding."""
    table = np.array([int.from_bytes(f + b"\t", "little") for f in FIELDS], np.uint32)
    words = np.zeros((L, S_pad), np.uint32)
    words[:, :S] = table[rng.choice(len(FIELDS), size=(L, S), p=PICK)]
    words[:, S - 1] = (words[:, S - 1] & 0x00FFFFFF) | (10 << 24)
    return words.view(np.int32)


def text_case(name):
    """(words (L, S_pad) int32, n_samples); L is the Pallas text tile
    height at S_pad, so each case runs through the Pallas kernels too."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "pallas-300":  # tests/test_pallas.py's shapes
        return text_words(rng, _block_l(384, 2), 300, 384), 300
    if name == "pallas-290":
        return text_words(rng, _block_l(384, 2), 290, 384), 290
    if name in ("S=1", "S=127", "S=128"):
        S = int(name[2:])
        return text_words(rng, _block_l(128, 2), S, 128), S
    if name == "bad-separators":
        words = text_words(rng, _block_l(384, 2), 300, 384)
        rows = np.arange(64)
        cols = rng.integers(0, 299, 64)
        words[rows, cols] = (words[rows, cols] & 0x00FFFFFF) | (ord("x") << 24)
        words[64:128, 299] = (words[64:128, 299] & 0x00FFFFFF) | (ord("x") << 24)  # not checked
        return words, 300
    if name == "zero-rows":
        words = text_words(rng, _block_l(2560, 2), 2504, 2560)
        words[::3] = 0  # gather_text's rows for irregular lines and padding
        return words, 2504
    if name == "random-words":
        return rng.integers(-(1 << 31), 1 << 31, (_block_l(1024, 2), 1024)).astype(np.int32), 1000
    if name == "width-16384":
        return text_words(rng, _block_l(16384, 2), 16300, 16384), 16300
    raise KeyError(name)


TEXT_CASES = [
    "pallas-300", "pallas-290", "S=1", "S=127", "S=128", "bad-separators",
    "zero-rows", "random-words", "width-16384",
]
