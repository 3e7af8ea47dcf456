"""What ``tools/flash_variants.py`` and ``tools/quant_variants.py`` share:
build whole-source variants of one of the port's kernel libraries with the
port's ``nvcc`` flags, count the SASS opcodes of their kernels, and time a
call on the card as ``chip_smoke.py``'s Timer does."""
import collections
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_all(build, lib_name, srcs):
    """Build every source in ``srcs`` (one ``nvcc`` each, all at once) into
    ``build/variants/`` and load it with the argtypes of ``lib_name``;
    prints each build's exit code, its kernels' names, registers and
    spills.  Returns ``[(src, path, CDLL)]`` for the builds that
    succeeded; entry points that a source lacks (an older interface) are
    left for the caller to type."""
    out_dir = os.path.join(ROOT, "build", "variants")
    nvcc = build.find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, src in enumerate(srcs):
        out = os.path.join(out_dir, "lib%s_variant%d.so" % (lib_name, i))
        procs.append((src, out, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for src, out, proc in procs:
        log, _ = proc.communicate()
        print("== %s: nvcc exit %d" % (src, proc.returncode))
        for line in log.splitlines():
            if "error" in line or "Used" in line or "entry function" in line \
                    or ("spill" in line and "0 bytes spill" not in line):
                print("   " + line.strip()[:150])
        if proc.returncode:
            continue
        lib = ctypes.CDLL(out)
        for fn, argtypes in build._SIGNATURES[lib_name].items():
            if hasattr(lib, fn):       # an older source has older entries
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs.append((src, out, lib))
    return libs


def sass_counts(path, name_re):
    """Opcode counts of the library's kernels whose mangled name matches
    ``name_re``, keyed by the regex's groups joined (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True).stdout
    fn, hist = None, collections.defaultdict(collections.Counter)
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kind = re.search(name_re, m.group(1))
            fn = "".join(g for g in kind.groups() if g) if kind else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if fn and m:
            hist[fn][m.group(2)] += 1
    return hist


def card_timer(torch):
    """Print the card's name and power limit; return ``timer(fn)``: the
    median device ms of 25 calls, each after a 64 MB read that evicts the
    L2 and a spin kernel that hides the host's enqueue (at least ~1 ms,
    and twice the host's enqueue time of one call at up to 2 GHz)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    flush = torch.ones(16 << 20, device="cuda")

    def timer(fn, iters=25):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()                          # the host's enqueue time of one call
        spin = max(2_000_000, min(int((time.perf_counter() - t0) * 4e9),
                                  400_000_000))
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            flush.sum()
            torch.cuda._sleep(spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    return timer
