import numpy as np
import pytest

from bucketmap_tpu.cli import main as cli_main
from bucketmap_tpu.io.fasta import write_fasta
from bucketmap_tpu.ops.encoding import decode_to_ascii
from bucketmap_tpu.sim.simulator import random_genome


# q=8 keeps per-bucket q-gram density low like the real q=9/65536 regime,
# so the distinguishability filter retains enough k-mers on toy buckets
ARGS = ["--bucket-len", "4096", "-r", "150", "-k", "8", "-l", "11", "-s", "8"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    recs = random_genome(300_000, seed=9, n_refs=2, name_prefix="chr")
    write_fasta(d / "g.fasta", [(r.id, decode_to_ascii(r.codes)) for r in recs])
    assert cli_main(["index", "-g", str(d / "g.fasta"), "-i", "t",
                     "--index-dir", str(d), "--export-reference-format"] + ARGS) == 0
    assert cli_main(["simulate", "-g", str(d / "g.fasta"), "-o", str(d),
                     "--name", "rd", "-c", "300", "--seed", "3"] + ARGS) == 0
    return d


def test_cli_index_map_analyze(workdir, capsys, monkeypatch):
    d = workdir
    # the CLI's compile-cache helper then leaves JAX's config untouched
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d / "jax_cache"))
    assert (d / "t.qgram").exists() and (d / "t.bmtpu.qgram_words.npy").exists()
    assert cli_main(["map", "-i", "t", "-q", str(d / "rd.fastq"),
                     "-o", str(d / "out.sam"), "--index-dir", str(d),
                     "--batch-size", "128"] + ARGS) == 0
    assert cli_main(["analyze-sam", str(d / "out.sam"),
                     "--fastq", str(d / "rd.fastq"),
                     "--ground-truth", str(d / "rd.position_ground_truth"),
                     "--tolerance", "10"]) == 0
    out = capsys.readouterr().out
    assert "sensitivity" in out

    from bucketmap_tpu.bench.sam_analyzer import SamAnalyzer
    an = SamAnalyzer(error_tolerance=10)
    an.read_sequence_file(d / "rd.fastq")
    an.read_ground_truth_file(d / "rd.position_ground_truth")
    res = an.benchmark(d / "out.sam", quiet=True)
    assert res.sensitivity_pct >= 90
    assert res.precision_pct >= 90


def test_cli_align_mode_and_reference_index_load(workdir, monkeypatch):
    d = workdir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d / "jax_cache"))
    # load via the reference-format files (exercise import path + align)
    import os
    os.rename(d / "t.bmtpu.json", d / "t_hidden.json")
    try:
        assert cli_main(["map", "-i", "t", "-q", str(d / "rd.fastq"),
                         "-o", str(d / "out_al.sam"), "--index-dir", str(d),
                         "-g", str(d / "g.fasta"), "--align",
                         "--batch-size", "128"] + ARGS) == 0
    finally:
        os.rename(d / "t_hidden.json", d / "t.bmtpu.json")
    from bucketmap_tpu.io.sam import read_sam
    recs = list(read_sam(d / "out_al.sam"))
    assert len(recs) >= 250
    # wrap-kept records (mapq > 60 after the uint8 wrap) emit '*'
    # (PARITY.md DIVERGENCES); genuine records all carry CIGARs
    assert all(r["cigar"] != "*" for r in recs if r["mapq"] <= 60)


def test_analyze_fastq(workdir, capsys):
    assert cli_main(["analyze-fastq", str(workdir / "rd.fastq")]) == 0
    assert "Estimated error rate" in capsys.readouterr().out


def test_best_alignment_pseudo_truth(workdir):
    # our own SAM as pseudo-truth scores itself at 100%
    from bucketmap_tpu.bench.sam_analyzer import SamAnalyzer
    d = workdir
    an = SamAnalyzer(error_tolerance=5)
    an.read_sequence_file(d / "rd.fastq")
    an.read_best_alignment_file(d / "out.sam")
    res = an.benchmark(d / "out.sam", quiet=True)
    assert res.precision_pct == 100.0

def test_dwgsim_read_name_truth(tmp_path):
    """Real-format dwgsim fixture: ground truth encoded in read names as
    <ref>_<pos>_<pos2>_<strand>_<strand2>_<rand>_<rand2>_<edits>:... with
    a one-underscore reference name (sam_file_analyzer.cpp:199-231)."""
    from bucketmap_tpu.bench.sam_analyzer import SamAnalyzer

    d = tmp_path
    (d / "ref.fasta").write_text(
        ">NC_000001.1 synthetic chr A\nACGTACGTACGT\n"
        ">NC_000002.1 synthetic chr B\nTTTTACGTACGT\n")
    reads = [
        # (name, expected: ref_idx, offset, rc, random)
        ("NC_000001.1_100_300_0_1_0_0_1:0:0_2:0:0_abc/1", 0, 100, False, False),
        ("NC_000002.1_55_200_1_0_0_0_0:0:0_0:0:0_def/1", 1, 55, True, False),
        ("NC_000001.1_7_9_0_0_1_1_0:0:0_0:0:0_ghi/2", 0, 7, False, True),
    ]
    with open(d / "r.fastq", "w") as f:
        for name, *_ in reads:
            f.write(f"@{name}\nACGTACGT\n+\nEEEEEEEE\n")

    an = SamAnalyzer(error_tolerance=5)
    an.read_fasta_file(d / "ref.fasta")
    an.read_sequence_file(d / "r.fastq", is_dwgsim=True)
    assert [a[0].sequence_id for a in an.answer] == [0, 1, 0]
    assert [a[0].offset for a in an.answer] == [100, 55, 7]
    assert [a[0].reverse_complement for a in an.answer] == [False, True, False]
    assert an.is_random_read == [False, False, True]

    # SAM: read0 correct (within tol, strand/ref match), read1 wrong
    # strand, read2 (random) mapped -> false positive
    with open(d / "out.sam", "w") as f:
        f.write("@SQ\tSN:NC_000001.1\tLN:12\n@SQ\tSN:NC_000002.1\tLN:12\n")
        f.write(f"{reads[0][0]}\t0\tNC_000001.1\t104\t60\t8M\t*\t0\t0\t"
                "ACGTACGT\tEEEEEEEE\n")       # pos0=103, |103-100|<=5 OK
        f.write(f"{reads[1][0]}\t0\tNC_000002.1\t56\t60\t8M\t*\t0\t0\t"
                "ACGTACGT\tEEEEEEEE\n")       # fwd but truth is rc -> wrong
        f.write(f"{reads[2][0]}\t16\tNC_000001.1\t8\t60\t8M\t*\t0\t0\t"
                "ACGTACGT\tEEEEEEEE\n")       # random read mapped -> FP
    res = an.benchmark(d / "out.sam", quiet=True)
    assert res.total_reads == 3 and res.random_reads == 1
    assert res.mapped_reads == 3
    assert res.correctly_mapped == 1
    assert res.mapped_random_reads == 1 and res.false_positive_pct == 100.0
    assert res.acceptable_locations == 1


def test_pbsim3_maf_truth(tmp_path):
    """Real-format pbsim3 .maf fixture: 15-token a/s/s record groups,
    read names S<ref#>_<read#> (sam_file_analyzer.cpp:151-177)."""
    from bucketmap_tpu.bench.sam_analyzer import SamAnalyzer

    d = tmp_path
    with open(d / "r.fastq", "w") as f:
        for name in ("S1_1", "S1_2", "S2_1"):
            f.write(f"@{name}\nACGTACGTACGT\n+\nEEEEEEEEEEEE\n")
    # pbsim3 maf: per read one 'a' line + ref 's' line + read 's' line
    (d / "truth.maf").write_text(
        "a\n"
        "s ref1 4000 12 + 4641652 ACGTACGTACGT\n"
        "s S1_1 0 12 + 12 ACGTACGTACGT\n"
        "a\n"
        "s ref1 9000 12 + 4641652 ACGTACGTACGT\n"
        "s S1_2 0 12 - 12 ACGTACGTACGT\n"
        "a\n"
        "s ref2 77 12 + 999999 ACGTACGTACGT\n"
        "s S2_1 0 12 + 12 ACGTACGTACGT\n")

    an = SamAnalyzer(error_tolerance=5)
    an.read_sequence_file(d / "r.fastq")
    an.read_ground_truth_file(d / "truth.maf")
    assert [a[0].offset for a in an.answer] == [4000, 9000, 77]
    assert [a[0].sequence_id for a in an.answer] == [0, 0, 1]
    assert [a[0].reverse_complement for a in an.answer] == [False, True, False]

    with open(d / "out.sam", "w") as f:
        f.write("@SQ\tSN:chr1\tLN:4641652\n@SQ\tSN:chr2\tLN:999999\n")
        f.write("S1_1\t0\tchr1\t4003\t60\t12M\t*\t0\t0\t"
                "ACGTACGTACGT\tEEEEEEEEEEEE\n")   # pos0=4002, within 5
        f.write("S1_2\t16\tchr1\t9001\t60\t12M\t*\t0\t0\t"
                "ACGTACGTACGT\tEEEEEEEEEEEE\n")   # rc matches, pos0=9000
        f.write("S2_1\t0\tchr2\t200\t60\t12M\t*\t0\t0\t"
                "ACGTACGTACGT\tEEEEEEEEEEEE\n")   # off by 122 -> wrong
    res = an.benchmark(d / "out.sam", quiet=True)
    assert res.total_reads == 3 and res.mapped_reads == 3
    assert res.correctly_mapped == 2
    assert res.acceptable_locations == 2
    assert res.uniquely_mapped_truth == 3
