"""Numpy models of the text kernels' word arithmetic (K3 and K4 of
vcfc_tpu_torch/csrc/rle_kernels.cu) against the port and vcfc_tpu.

K3 classifies each 4-byte "a|b<sep>" word without branches (x = t ^
"0|0\\t": valid iff x & 0x00FEFFFE is 0, then code (x & 1) << 1 | x >> 16 &
1, else 4; a bad separator iff x > 0xFFFFFF), four words at a time (bytes
gathered by __byte_perm into one word each) into a code word, and runs
K1's group arithmetic on a group's four code words.
K4 runs K2's group arithmetic and renders the words from the codes, one
code word (four cells) at a time.  The models below are those operations
on numpy uint32 arrays, as the kernels write them; the word-level ones are
held exhaustively to the port's ``_classify_words`` / ``_render_words``
and to ``vcfc_tpu.ops.pallas_rle``'s (on the CPU backend), the
kernel-level ones to ``text_rle_encode_plain`` / ``text_rle_decode_plain``
on ``vcfc_tpu_torch.eval.edge_cases.text_edge_cases`` (the encode edge
cases as words, and bad separators on group and round edges), on the
text cases of tests/test_torch_text.py and on malformed flag planes.
Every output is integers, so every comparison is exact, element by
element.  The CUDA kernels themselves are held to the plain versions in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_word_models import (
    TEXT_CASES,
    U,
    below,
    byte_msbs,
    byte_perm,
    k1_word_model,
    k2_word_model,
    msbs_to_bytes,
    nonzero,
    splat,
    text_case,
    to_bytes,
    to_word,
    u,
)

from vcfc_tpu.ops import pallas_rle
from vcfc_tpu_torch.eval.edge_cases import (
    VALID_WORDS,
    flag_edge_cases,
    separator_edge_cases,
    text_edge_cases,
)
from vcfc_tpu_torch.ops import cuda_rle, probe
from vcfc_tpu_torch.ops import rle as torch_rle

TAB_WORD = 0x09307C30  # "0|0\t" as a little-endian word


def _classify_model(t):
    """K3's classify and separator test of each word: (code, bad) uint32."""
    x = u(t) ^ U(TAB_WORD)
    pair = ((x & U(1)) << U(1)) | ((x >> U(16)) & U(1))
    code = np.where((x & U(0x00FEFFFE)) != 0, U(4), pair)
    return code, (x > U(0x00FFFFFF)).astype(U)


def _codes_model(t):
    """K3's classify of four words at a time (Text::codes): t is four
    (L,) uint32 words -> (their code word, their bad-separator bits)."""
    even01, even23 = byte_perm(t[0], t[1], 0x6240), byte_perm(t[2], t[3], 0x6240)
    odd01, odd23 = byte_perm(t[0], t[1], 0x7351), byte_perm(t[2], t[3], 0x7351)
    a = byte_perm(even01, even23, 0x5410) ^ splat(0x30)
    b = byte_perm(even01, even23, 0x7632) ^ splat(0x30)
    pipe = byte_perm(odd01, odd23, 0x5410) ^ splat(0x7C)
    sep = byte_perm(odd01, odd23, 0x7632) ^ splat(0x09)
    esc = msbs_to_bytes(nonzero(((a | b) & splat(0xFE)) | pipe))
    code = ((((a & splat(1)) << U(1)) | (b & splat(1))) & ~esc) | (esc & splat(4))
    return code, byte_msbs(nonzero(sep))


def _render_model(v, p, n):
    """One code word (cells p..p + 3) -> its 4 words, '\\n' at cell n - 1."""
    esc = ((v >> U(2)) & U(0x01010101)) * U(0x0F)
    b0 = splat(0x30) + ((v >> U(1)) & U(0x01010101)) + esc
    b2 = splat(0x30) + (v & U(0x01010101)) + esc
    lo, hi = byte_perm(b0, b2, 0x5140), byte_perm(b0, b2, 0x7362)
    t = [byte_perm(lo, 0x097C, 0x5140), byte_perm(lo, 0x097C, 0x5342),
         byte_perm(hi, 0x097C, 0x5140), byte_perm(hi, 0x097C, 0x5342)]
    last = n - 1 - p
    if 0 <= last < 4:
        t[last] = t[last] ^ U(0x03 << 24)
    return np.stack(t, axis=1)


def _render_plane(codes, n):
    """K4's render over a code plane: each lane's store covers 4 cells,
    rendered from their code word (zero codes past the width)."""
    L, W = codes.shape
    padded = np.zeros((L, -(-W // 4) * 4), np.uint8)
    padded[:, :W] = codes
    words = [_render_model(to_word(padded[:, p : p + 4]), p, n) for p in range(0, W, 4)]
    return np.concatenate(words, axis=1)[:, :W].view(np.int32)


def _k3_word_model(words, n):
    """K3 group by group: 16 words classified into four code words, then
    K1's group arithmetic (``k1_word_model``) on those codes;
    seps_ok from the bad-separator bits below min(n - 1, w).  Past the
    width K3 classifies zero words (code 4) where the model pads with code
    0; neither reaches an output."""
    L, W = words.shape
    codes = np.zeros((L, W), np.uint8)
    bad = np.zeros(L, U)
    checked = min(n - 1, W)
    for p0 in range(0, W, 16):
        cut = min(16, W - p0)
        raw = np.zeros((L, 16), U)
        raw[:, :cut] = u(words[:, p0 : p0 + cut].view(np.uint32))
        x, bits = [], U(0)
        for j in range(4):
            word, b = _codes_model([raw[:, 4 * j + k] for k in range(4)])
            x.append(word)
            bits = bits | (b << U(4 * j))
        codes[:, p0 : p0 + cut] = np.stack([to_bytes(w) for w in x], axis=1).reshape(L, 16)[:, :cut]
        bad |= bits & below(checked - p0)
    flags, nseg = k1_word_model(codes, n)
    return flags, nseg, (bad == 0).astype(np.int32)


def _k4_word_model(flags, n):
    """K4: K2's group arithmetic (``k2_word_model``), then the words
    rendered from the codes four cells a store."""
    codes, decoded = k2_word_model(flags, n)
    return _render_plane(codes, n), codes, decoded


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- the word operations, exhaustively ---------------------------------------

@pytest.mark.parametrize("byte", [0, 1, 2, 3], ids=["byte0", "byte1", "byte2", "separator"])
@pytest.mark.parametrize("base", VALID_WORDS, ids=[f.decode()[:3] for f in VALID_WORDS])
def test_classify_model_matches_both_classifiers(byte, base):
    """All 256 values of one byte of a valid word, the other bytes kept."""
    t = np.full(256, int.from_bytes(base, "little"), np.uint32)
    t = (t & U(~(0xFF << (8 * byte)) & 0xFFFFFFFF)) | (np.arange(256, dtype=U) << U(8 * byte))
    code, bad = _classify_model(t)
    four = [t.reshape(64, 4)[:, k] for k in range(4)]
    code4, bad4 = _codes_model(four)
    np.testing.assert_array_equal(to_bytes(code4).reshape(256), code)
    np.testing.assert_array_equal((bad4[:, None] >> np.arange(4, dtype=U)) & U(1),
                                  bad.reshape(64, 4))
    words = t.view(np.int32)[None, :]
    port_codes, port_sep = torch_rle._classify_words(_t(words))
    jax_codes, jax_sep = pallas_rle._classify_words(jnp.asarray(words))
    for codes, sep in ((port_codes.numpy(), port_sep.numpy()),
                       (np.asarray(jax_codes), np.asarray(jax_sep))):
        np.testing.assert_array_equal(code, codes[0])
        np.testing.assert_array_equal(bad, (sep[0] != 9).astype(U))
    assert (code < 4).sum() == (256 if byte == 3 else 2 if byte in (0, 2) else 1)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 16, 17, 47, 48, 100])
def test_render_model_matches_both_renderers(n):
    """Codes 0-4 on every cell of 48, so each code falls on n - 1 and off
    it, n - 1 on each cell of a store and on none."""
    rng = np.random.default_rng(n)
    codes = np.concatenate([np.repeat(np.arange(5), 48).reshape(5, 48),
                            rng.integers(0, 5, (11, 48))]).astype(np.uint8)
    got = _render_plane(codes, n)
    c32 = codes.astype(np.int32)
    np.testing.assert_array_equal(got, torch_rle._render_words(_t(c32), n).numpy())
    idx = np.broadcast_to(np.arange(48, dtype=np.int32), c32.shape)
    np.testing.assert_array_equal(
        got, np.asarray(pallas_rle._render_words(jnp.asarray(c32), n, jnp.asarray(idx))))
    newline = (got.view(np.uint32) >> 24) == 10
    assert newline.sum() == (16 if 1 <= n <= 48 else 0)


def test_codes_model_puts_word_k_in_byte_k():
    words = [b"0|1\t", b"1|0\t", b"1|1\tx"[:4], b"./.\n"]
    code, bad = _codes_model([np.array([int.from_bytes(w, "little")], U) for w in words])
    assert int(code[0]) == 0x04030201 and int(bad[0]) == 0b1000


# --- the kernels' group arithmetic -------------------------------------------

TEXT_EDGE = text_edge_cases()
SEP_EDGE = separator_edge_cases()
FLAG_EDGE = flag_edge_cases()


def _text_encode_case(name):
    for case, words, n in TEXT_EDGE:
        if case == name:
            return words, n
    return text_case(name)


ENCODE_CASES = [name for name, _, _ in TEXT_EDGE] + TEXT_CASES


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_k3_word_model_matches_plain(name):
    words, n = _text_encode_case(name)
    _assert_equal(_k3_word_model(words, n), torch_rle.text_rle_encode_plain(_t(words), n))


def _malformed(seed, W, n):
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 256, (64, W), dtype=np.uint8)
    flags[rng.random((64, W)) < 0.97] = 0  # gaps past 127 cells
    flags[:4] = 0
    return flags, n


DECODE_CASES = ([name for name, _, _ in FLAG_EDGE] + ["malformed 384", "malformed 1000",
                                                      "malformed 2560", "malformed 128"]
                + [f"flags of {name}" for name in TEXT_CASES + [SEP_EDGE[0][0]]])


def _text_decode_case(name):
    for case, flags, n in FLAG_EDGE:
        if case == name:
            return flags, n
    if name.startswith("malformed"):
        W = int(name.split()[1])
        return _malformed(W, W, {384: 300, 1000: 990, 2560: 2504, 128: 1}[W])
    words, n = _text_encode_case(name.removeprefix("flags of "))
    return torch_rle.text_rle_encode_plain(_t(words), n)[0].numpy(), n


@pytest.mark.parametrize("name", DECODE_CASES)
def test_k4_word_model_matches_plain(name):
    flags, n = _text_decode_case(name)
    _assert_equal(_k4_word_model(flags, n), torch_rle.text_rle_decode_plain(_t(flags), n))


def test_separator_edge_cases_flag_their_rows():
    """Rows with a bad separator below n - 1 fail the check, the others
    (none, or one at n - 1 or past it) pass it."""
    for _name, words, n in SEP_EDGE:
        seps = words.view(np.uint32) >> 24
        want = ((seps[:, : n - 1] != 9).sum(axis=1) == 0).astype(np.int32)
        assert 0 < want.sum() < len(want)
        _assert_equal(_k3_word_model(words, n)[2:], [want])


# --- the earlier tile designs C6 and C7 ---------------------------------------

def test_cpu_tensors_take_the_plain_tile_text_probes():
    words, n = _text_encode_case(SEP_EDGE[1][0])
    before = dict(cuda_rle.LAUNCHES)
    x = _t(words)
    _assert_equal(probe.probe_tile_text_encode(x, n), torch_rle.text_rle_encode_plain(x, n))
    flags = torch_rle.text_rle_encode_plain(x, n)[0]
    _assert_equal(probe.probe_tile_text_decode(flags, n), torch_rle.text_rle_decode_plain(flags, n))
    assert cuda_rle.LAUNCHES == before


@pytest.mark.parametrize(
    "wrapper,dtype",
    [(cuda_rle.cuda_probe_tile_text_encode, torch.int32),
     (cuda_rle.cuda_probe_tile_text_decode, torch.uint8)],
    ids=["C6", "C7"],
)
@pytest.mark.parametrize("fault", ["dtype", "non-contiguous", "cpu"])
def test_tile_text_probes_reject_what_the_kernels_do_not_take(wrapper, dtype, fault):
    other = torch.uint8 if dtype == torch.int32 else torch.int32
    plane = {"dtype": torch.zeros((4, 128), dtype=other),
             "non-contiguous": torch.zeros((128, 4), dtype=dtype).t(),
             "cpu": torch.zeros((4, 128), dtype=dtype)}[fault]
    with pytest.raises(TypeError if fault == "dtype" else ValueError):
        wrapper(plane, 100)
