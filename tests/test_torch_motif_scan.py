"""The port's built-in FIMO-compatible scanner
(expecto_tpu_torch/analysis/motif_scan.py) vs the JAX package's, on the
CPU: MEME parsing, log-odds, the Staden p-value table, window scores, and
the ``--text`` output byte for byte, on hand-written and seeded motif files
and FASTA records (N runs, lower case, records shorter than a motif)."""

import numpy as np
import pytest

from expecto_tpu.analysis import motif_scan as jscan
from expecto_tpu_torch.analysis import motif_scan as tscan
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

MEME_TEXT = """\
MEME version 4

ALPHABET= ACGT

strands: + -

Background letter frequencies
A 0.3 C 0.2 G 0.2 T 0.3

MOTIF M1 TFA
letter-probability matrix: alength= 4 w= 3 nsites= 20 E= 0
 0.90 0.05 0.03 0.02
 0.02 0.03 0.05 0.90
 0.05 0.85 0.05 0.05

MOTIF M2 TFB
letter-probability matrix: alength= 4 w= 4 nsites= 10 E= 0
 0.25 0.25 0.25 0.25
 0.97 0.01 0.01 0.01

 0.01 0.01 0.97 0.01
 0.25 0.25 0.25 0.25

MOTIF M3
letter-probability matrix: alength= 4 w= 2 E= 0
 1.0 0.0 0.0 0.0
 0.0 0.0 0.0 1.0
"""


def seeded_meme(seed: int, n_motifs: int = 24, widths=(6, 20), background: bool = True) -> str:
    """A MEME file of ``n_motifs`` seeded Dirichlet motifs of widths in
    ``widths`` (nsites from 5 to 60), with or without a background block."""
    rng = np.random.default_rng(seed)
    out = ["MEME version 5", "", "ALPHABET= ACGT", ""]
    if background:
        bg = rng.dirichlet([8, 8, 8, 8])
        out += ["Background letter frequencies", " ".join(f"{b} {p:.4f}" for b, p in zip("ACGT", bg)), ""]
    for m in range(n_motifs):
        w = int(rng.integers(widths[0], widths[1] + 1))
        probs = rng.dirichlet([0.4] * 4, size=w)
        out += [f"MOTIF MA{m:04d}.1 TF{m}", f"letter-probability matrix: alength= 4 w= {w} nsites= "
                f"{int(rng.integers(5, 61))} E= 0"]
        out += [" " + " ".join(f"{p:.6f}" for p in row) for row in probs] + [""]
    return "\n".join(out) + "\n"


def seeded_fasta(seed: int, n_records: int = 12, length: int = 61) -> str:
    """Seeded records of ``length`` bases with N runs, lower-case stretches
    and one record shorter than most motifs."""
    rng = np.random.default_rng(seed)
    recs = []
    for r in range(n_records):
        n = 9 if r == n_records - 1 else length
        seq = np.array(list("ACGT"))[rng.integers(0, 4, n)]
        if r % 3 == 0:
            start = int(rng.integers(0, n - 5))
            seq[start : start + int(rng.integers(1, 6))] = "N"
        text = "".join(seq)
        if r % 4 == 1:
            text = text[:20].lower() + text[20:]
        recs.append(f">rs{r}\n{text}")
    return "\n".join(recs) + "\n"


@pytest.fixture()
def meme_file(tmp_path):
    p = tmp_path / "motifs.meme"
    p.write_text(MEME_TEXT)
    return str(p)


@pytest.mark.parametrize("kind", ["hand", "seeded", "seeded_no_background"])
def test_parse_meme_equal_jax(tmp_path, kind):
    text = MEME_TEXT if kind == "hand" else seeded_meme(1, background=kind == "seeded")
    (tmp_path / "m.meme").write_text(text)
    (jm, jbg), (tm, tbg) = jscan.parse_meme(str(tmp_path / "m.meme")), tscan.parse_meme(str(tmp_path / "m.meme"))
    np.testing.assert_array_equal(tbg, jbg)
    assert [(m.motif_id, m.alt_id, m.nsites, m.width) for m in tm] == [(m.motif_id, m.alt_id, m.nsites, m.width)
                                                                       for m in jm]
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.probs, b.probs)


@pytest.mark.parametrize("text,match", [("MEME version 4\n\nALPHABET= ACGT\n", "no MOTIF blocks"),
                                        ("MOTIF X\nnothing else\n", "missing letter-probability matrix")])
def test_parse_meme_errors_equal_jax(tmp_path, text, match):
    (tmp_path / "bad.meme").write_text(text)
    for mod in (jscan, tscan):
        with pytest.raises(ValueError, match=match):
            mod.parse_meme(str(tmp_path / "bad.meme"))


@pytest.mark.parametrize("pseudo", [tscan.MOTIF_PSEUDO, 0.0, 1.0])
def test_log_odds_and_pvalue_table_equal_jax(tmp_path, pseudo):
    (tmp_path / "m.meme").write_text(seeded_meme(2, n_motifs=6))
    motifs, bg = tscan.parse_meme(str(tmp_path / "m.meme"))
    jmotifs, _ = jscan.parse_meme(str(tmp_path / "m.meme"))
    assert tscan.SCORE_SCALE == jscan.SCORE_SCALE == 1000 and tscan.MOTIF_PSEUDO == jscan.MOTIF_PSEUDO
    for m, jm in zip(motifs, jmotifs):
        lo = tscan.log_odds(m, bg, pseudo)
        np.testing.assert_array_equal(lo, jscan.log_odds(jm, bg, pseudo))
        if pseudo == 0.0:
            continue  # zero probabilities give -inf log-odds, which the DP does not take
        (q, lookup), (jq, jlookup) = tscan.pvalue_lookup(lo, bg), jscan.pvalue_lookup(lo, bg)
        np.testing.assert_array_equal(q, jq)
        scores = np.arange(q.min(axis=1).sum() - 3, q.max(axis=1).sum() + 4)
        np.testing.assert_array_equal(lookup(scores), jlookup(scores))
        # the survival function is a float sum: at the lowest score it may pass 1 by a few ulps
        assert abs(lookup(scores)[0] - 1.0) < 1e-12 and 0.0 < lookup(scores)[-4] <= lookup(scores)[0]


@pytest.mark.parametrize("seq", ["ACGTACGTTGCA", "ACGNNNNNNACG", "acgtNacgt", "AC", ""])
def test_window_scores_and_encoding_equal_jax(meme_file, seq):
    motifs, bg = tscan.parse_meme(meme_file)
    codes = tscan._encode(seq)
    np.testing.assert_array_equal(codes, jscan._encode(seq))
    for m in motifs:
        lo = tscan.log_odds(m, bg)
        q, _ = tscan.pvalue_lookup(lo, bg)
        for mat in (q, lo):
            (s, v), (js, jv) = tscan._window_scores(codes, mat), jscan._window_scores(codes, mat)
            np.testing.assert_array_equal(s, js)
            np.testing.assert_array_equal(v, jv)
            assert s.dtype == js.dtype


SCAN_CASES = {
    "hand": (MEME_TEXT, ">rs1\nTTTTTCTTTTTT\n>rs2\nACGNNNNNNACG\n>rs3\nATATATATATATCTATATATATG\n", 1.0),
    "seeded_24_motifs": (seeded_meme(3), seeded_fasta(4), 1.0),
    "seeded_thresh": (seeded_meme(5, n_motifs=8), seeded_fasta(6, n_records=20), 1e-2),
    "seeded_no_background": (seeded_meme(7, n_motifs=5, background=False), seeded_fasta(8, length=200), 1.0),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_to_text_byte_for_byte(tmp_path, case):
    meme, fasta, thresh = SCAN_CASES[case]
    (tmp_path / "m.meme").write_text(meme)
    (tmp_path / "q.fa").write_text(fasta)
    args = (str(tmp_path / "m.meme"), str(tmp_path / "q.fa"))
    tscan.scan_to_text(*args, str(tmp_path / "t.txt"), thresh=thresh)
    jscan.scan_to_text(*args, str(tmp_path / "j.txt"), thresh=thresh)
    got = (tmp_path / "t.txt").read_bytes()
    assert got == (tmp_path / "j.txt").read_bytes()
    lines = got.decode().splitlines()
    assert lines[0].split("\t")[0] == "motif_id" and len(lines) > 1
    if thresh == 1.0:
        assert len(lines) - 1 == printed_windows(args[0], fasta.split("\n")[1::2])


def printed_windows(motif_file: str, seqs: list) -> int:
    """The rows ``--thresh 1`` prints: every window without an N, both
    strands, except those at a motif's lowest score when its p-value there,
    a float sum, exceeds 1 (both packages' scanners leave them out)."""
    motifs, bg = tscan.parse_meme(motif_file)
    comp = str.maketrans("ACGT", "TGCA")
    n = 0
    for m in motifs:
        q, lookup = tscan.pvalue_lookup(tscan.log_odds(m, bg), bg)
        drop_lowest = lookup(np.array([q.min(axis=1).sum()]))[0] > 1.0
        for seq in seqs:
            for s in (seq.upper(), seq.upper().translate(comp)[::-1]):
                for i in range(len(s) - m.width + 1):
                    win = s[i : i + m.width]
                    if "N" in win:
                        continue
                    lowest = all(q[j, "ACGT".index(b)] == q[j].min() for j, b in enumerate(win))
                    n += not (lowest and drop_lowest)
    return n
