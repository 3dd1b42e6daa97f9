"""modutils: modset lifecycle tool (reference: modutils.c).

Same ordered-command surface and output text as the reference; the k-mer
scan runs on the device path (ops/seqhash.py) with exact-replay table
construction, so outputs are byte/record-identical while hashing is batched.
"""

import os
import sys

import numpy as np

from ..core.modset import Modset
from ..core.seqhash import Seqhash
from ..io import seqio
from ..ops.seqhash import ModimizerScanner
from ..utils.timers import Timer
from .common import cli_guard, Args, OutFile, die, finish


def usage():
    e = sys.stderr.write
    e("Usage: modutils <commands>\n")
    e("Commands are executed in order - set parameters before using them!\n")
    e("  -v | --verbose : toggle verbose mode\n")
    e("  -o | --output <output filename> : '-' for stdout\n")
    e("  -c | --modcreate table_bits{28} kmer{19} mod{31} seed{17}: can truncate parameters\n")
    e("  -w | --write <mod file> : custom binary\n")
    e("  -r | --read <mod file>\n")
    e("  -wt | --writetext <text file> : kmer,count,flags tab-separated\n")
    e("  -rt | --readtext <text file>  : hasher params in header line\n")
    e("  -a | --add <read file> : add kmers from read file\n")
    e("  -x | --add10x <10x read file> : add kmers from 10x read file\n")
    e("  -m | --merge <mod file> : add kmers from read file; writes depths\n")
    e("  -p | --prune <min> <max> : remove mod entries < min or >= max\n")
    e("  -s | --setcopy <copy1min> <copy2min> <copyMmin> : reset mod copy\n")
    e("  -sM | --setcopyM <copyMmin> : set copyM if depth > copyMmin\n")
    e("  -H | --hist <outfile> : print depth histogram\n")
    e("  -d | --depth <outfile> <mod file>* : print depth per mod [also in other files]\n")
    e("  -P | --refpaint <ref seqfile> : print depth per mod along a reference sequence\n")
    e("command -c or -r must come before other commands from -w onwards\n")
    e("read files can be fasta or fastq, gzipped or not\n")
    e("example usage\n")
    e("  modutils -c 30 19 31 17 -a XR1.fa.gz -a XR2.fa.gz -w X.mod\n")
    e("  modutils -c 30 19 31 17 -a YR1.fa.gz -a YR2.fa.gz -w Y.mod\n")
    e("  modutils -r X.mod -m Y.mod -w XY1.mod -H XY.his\n")
    e("then look at histogram XY.his and decide on thresholds, then\n")
    e("  modutils -r XY1.mod -p 5 200 -s 10 50 100 -w XY2.mod\n")
    e("  modutils -r XY2.mod -d XY.depths X.mod Y.mod\n")
    e("XY.depths will have columns: hash, depth_in_XY2, depth_inX, depth_in_Y\n")


# streams >= 32 Mbase count on device (the sharded builder); inherited
# value, not measured on the card
DEVICE_COUNT_THRESHOLD = 1 << 25


def _est_stream_len(filename) -> int:
    """Cheap decompressed-size estimate for routing (file size; gzip ISIZE
    trailer, mod 2^32, for gzipped input).  -1 if the file is unreadable."""
    try:
        sz = os.path.getsize(filename)
        with open(filename, "rb") as f:
            if f.read(2) == b"\x1f\x8b" and sz >= 4:
                f.seek(-4, 2)
                sz = int.from_bytes(f.read(4), "little")
        return sz
    except OSError:
        return -1


def add_sequence_file(ms: Modset, scanner: ModimizerScanner, filename,
                      out, is10x=False) -> bool:
    """modutils addSequenceFile (modutils.c:33-51).

    Small inputs: device/host scan + exact replay insert of the raw k-mer
    stream.  Large inputs: fully device-resident sharded count (sorted
    segment-reduce per chunk, first-encounter position min-reduced), then one
    exact replay insert — bit-identical results either way.  FASTA/FASTQ
    inputs bound for the device scan take a parse-ahead streaming path:
    segments parse on a background thread while earlier chunks compute on
    device (identical chunking and insert stream to the whole-file path)."""
    est = _est_stream_len(filename)
    if est < 0:
        return False
    use_device = scanner.on_device(est)
    count_on_device = (use_device and est >= DEVICE_COUNT_THRESHOLD
                       and not os.environ.get("MODIMIZER_NO_DEVICE_COUNT"))
    if not is10x and not count_on_device and use_device:
        from ..io.stream_seq import iter_seq_batches
        try:
            it = iter_seq_batches(filename, seqio.dna2index_n0())
            first = next(it, None)
        except ValueError:
            pass        # not FASTA/FASTQ: generic whole-file path below
        except IOError:
            return False
        else:
            n_seq = tot_len = 0

            def _batches():
                nonlocal n_seq, tot_len
                for cb, ob in ([first] if first is not None else []):
                    n_seq += len(ob) - 1
                    tot_len += len(cb)
                    yield cb, ob
                for cb, ob in it:
                    n_seq += len(ob) - 1
                    tot_len += len(cb)
                    yield cb, ob

            n_hash = scanner.scan_kmers_batches(_batches(),
                                                consumer=ms.add_batch)
            out.write("added %d sequences total length %d total hashes %d,"
                      " new max %d\n" % (n_seq, tot_len, n_hash, ms.max))
            return True
    try:
        batch, _t = seqio.read_seq_file(filename, seqio.dna2index_n0(),
                                        is_qual=False, want_ids=False)
    except (IOError, ValueError, FileNotFoundError):
        return False
    offsets = np.asarray(batch.offsets, np.int64)
    codes = batch.codes
    tot_len = len(codes)
    if is10x:
        # odd records (1-based) skip a 23bp barcode (modutils.c:44)
        parts, lens = [], []
        for i in range(batch.n):
            s0 = offsets[i] + (23 if i % 2 == 0 else 0)
            s = codes[min(s0, offsets[i + 1]):offsets[i + 1]]
            parts.append(s)
            lens.append(len(s))
        codes = np.concatenate(parts) if parts else np.zeros(0, np.int8)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    if (len(codes) >= DEVICE_COUNT_THRESHOLD
            and not os.environ.get("MODIMIZER_NO_DEVICE_COUNT")
            and scanner.on_device(len(codes))):
        from ..ops import route
        from ..parallel.sharded import ShardedModsetBuilder, build_mesh
        builder = ShardedModsetBuilder(ms.hasher, build_mesh())
        builder.feed_stream(codes, offsets)
        uniq, counts = builder.finalize()
        n_hash = builder.total_emitted
        route.log(f"modset_build device n={len(codes)} "
                  f"devices={builder.n} chunk={builder.chunk} "
                  f"n_replay={builder.n_replay}")
        ms.add_batch(uniq, counts)
    else:
        # pipelined kmers-only scan: per-chunk table replay runs under the
        # device transfer time; identical insert stream either way
        n_hash = scanner.scan_kmers(codes, offsets, consumer=ms.add_batch)
    out.write("added %d sequences total length %d total hashes %d, new max %d\n"
              % (batch.n, tot_len, n_hash, ms.max))
    return True


def depth_histogram(ms: Modset, f):
    h = ms.depth_histogram()
    for i in range(len(h)):
        if h[i]:
            f.write("DP\t%d\t%d\n" % (i, h[i]))


def report_depths(ms: Modset, others, f):
    """modutils reportDepths (modutils.c:65-77)."""
    n = ms.max
    vals = ms.value[1:n + 1]
    cols = [other.find_batch(vals) for other in others]
    for i in range(n):
        f.write("MH\t%x\t%d\t%d" % (int(vals[i]), int(ms.info[i + 1] & 3),
                                    int(ms.depth[i + 1])))
        for j, other in enumerate(others):
            idx = cols[j][i]
            f.write("\t%d" % (int(other.depth[idx]) if idx else 0))
        f.write("\n")


@cli_guard
def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        usage()

    out = OutFile()
    timer = Timer()
    timer.update(sys.stdout)

    ms = None
    scanner = None
    args = Args(argv)

    def get_scanner():
        nonlocal scanner
        if scanner is None or scanner.sh is not ms.hasher:
            scanner = ModimizerScanner(ms.hasher)
        return scanner

    while args:
        if not args.current.startswith("-"):
            die("option/command %s does not start with '-': run without arguments for usage",
                args.current)
        args.echo_command()

        if args.match("-v", "--verbose", 1):
            pass
        elif (m := args.match("-o", "--output", 2)):
            out.set(m[1])
        elif ms is None and args.match("-c", "--create", 1):
            B, k, w, s = 28, 19, 31, 17
            vals = []
            while args and not args.current.startswith("-") and len(vals) < 4:
                vals.append(args.current)
                args.i += 1
            try:
                if len(vals) > 0:
                    B = int(vals[0])
                    if not B or B < 20 or B > 34:
                        die("bad modbuild B %s", vals[0])
                if len(vals) > 1:
                    k = int(vals[1])
                    if not k or k < 1:
                        die("bad modbuild k %s", vals[1])
                if len(vals) > 2:
                    w = int(vals[2])
                    if not w:
                        die("bad modbuild w %s", vals[2])
                if len(vals) > 3:
                    s = int(vals[3])
                    if not s:
                        die("bad modbuild w %s", vals[3])
            except ValueError:
                die("bad modbuild parameter")
            sh = Seqhash.create(k, w, s)
            out.write(sh.report())
            ms = Modset(sh, B, 0)
        elif ms is None and (m := args.match("-r", "--read", 2)):
            try:
                ms = Modset.read(m[1])
            except (IOError, FileNotFoundError):
                die("failed to open mod file %s", m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-w", "--write", 2)):
            ms.write(m[1])
        elif ms is None and (m := args.match("-rt", "--readtext", 2)):
            try:
                f = open(m[1])
            except OSError:
                die("failed to open text file %s", m[1])
            with f:
                ms = Modset.read_text(f)
            ms.summary(out)
        elif ms is not None and (m := args.match("-wt", "--writetext", 2)):
            try:
                f = open(m[1], "w")
            except OSError:
                die("failed to open text file %s", m[1])
            with f:
                ms.write_text(f)
        elif ms is not None and (m := args.match("-p", "--prune", 3)):
            ms.depth_prune(int(m[1]), int(m[2]))
            ms.summary(out)
        elif ms is not None and (m := args.match("-s", "--setcopy", 4)):
            ms.set_copy_thresholds(int(m[1]), int(m[2]), int(m[3]))
            ms.summary(out)
        elif ms is not None and (m := args.match("-sM", "--setcopyM", 2)):
            ms.set_copyM_threshold(int(m[1]))
            ms.summary(out)
        elif ms is not None and (m := args.match("-a", "--add", 2)):
            if not add_sequence_file(ms, get_scanner(), m[1], out):
                die("failed to open sequence file %s", m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-x", "--add10x", 2)):
            if not add_sequence_file(ms, get_scanner(), m[1], out, is10x=True):
                die("failed to open sequence file %s", m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-m", "--merge", 2)):
            try:
                ms2 = Modset.read(m[1])
            except (IOError, FileNotFoundError):
                die("failed to open mod file %s", m[1])
            ms2.summary(out)
            if not ms.merge(ms2):
                sys.stderr.write(
                    "modset %s incompatible with current - unable to merge\n" % m[1])
            ms.summary(out)
        elif ms is not None and (m := args.match("-H", "--hist", 2)):
            try:
                f = open(m[1], "w")
            except OSError:
                die("failed to open histogram file %s", m[1])
            with f:
                depth_histogram(ms, f)
        elif ms is not None and (m := args.match("-d", "--depths", 2)):
            try:
                fd = open(m[1], "w")
            except OSError:
                die("failed to open depths file %s", m[1])
            others = []
            for name in args.take_while_not_flag():
                try:
                    other = Modset.read(name)
                except (IOError, FileNotFoundError):
                    die("failed to open mod file %s", name)
                others.append(other)
                other.summary(out)
            with fd:
                report_depths(ms, others, fd)
        elif ms is not None and (m := args.match("-P", "--refpaint", 2)):
            try:
                batch, _t = seqio.read_seq_file(m[1], seqio.dna2index_n0(),
                                                is_qual=False, want_ids=True)
            except (IOError, ValueError, FileNotFoundError):
                die("failed to open ref seq file %s", m[1])
            sc = get_scanner()
            kmers, rid, rpos, _isF = sc.scan_batch(batch)
            idx = ms.find_batch(kmers)
            lens = batch.lengths
            for i in range(batch.n):
                sys.stdout.write("painting %s length %d\n"
                                 % (batch.ids[i], int(lens[i])))
                sel = rid == i
                for p, ix in zip(rpos[sel], idx[sel]):
                    if ix:
                        sys.stdout.write("  %d\t%d\n" % (int(p), int(ms.depth[ix])))
        else:
            die("unknown command %s - run without arguments for usage", args.current)

        timer.update(out.f)

    finish(out, timer)


if __name__ == "__main__":
    main()
