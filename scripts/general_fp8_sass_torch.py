"""Instructions a message of the general path's float8_e5m2 sum-product
kernels, counted in their SASS, split by what they do.

    python3 scripts/general_fp8_sass_torch.py [OUT_DIR]

Compiles, with the general library's nvcc flags (``_kernels.NVCC_FLAGS``,
``-cubin`` for ``-shared``) plus ``-lineinfo``, one source that takes the
address of each kernel below at the general cell's shapes (the check
kernel at degree 6, 8 lanes a thread; the variable kernel at degree 3, 16
lanes): the threshold-lookup kernels that the decoder launches
(csrc/general_e5m2.cuh), the design they replaced (csrc/general.cuh's
kernels on ``__nv_fp8_e5m2`` with ``PhiFast``, still the template of the
float32 and bfloat16 kernels) and the bfloat16 kernels beside them. It
checks that ``-lineinfo`` leaves the instructions as they are (the same
mnemonics without it), writes each kernel's listing with its source lines
(``nvdisasm --print-line-info-inline``) to ``OUT_DIR/general_fp8_sass.txt``
(default: the package's git-ignored ``build/``), and prints one JSON line
per kernel.

Per message: a thread walks ``rows`` nodes of its block's chunk; per node
the node loop's body runs once and the second pass's loop (the innermost
loop that stores) D times, over V lanes: (node body + (D - 1) x pass-2
body) / (D x V), plus the block's prologue (the table and source staging)
over the thread's rows x D x V messages, at B = 384 (``general_shape``,
``e5m2_shape`` for the threshold kernels).
The node body holds the emit block of the variable kernel, which a
non-emit pass skips. Each instruction's category comes from its source
line and the lines it was inlined at (``CATEGORIES``): phi (the fast phi,
or the lookup: clamps, bucket, shared load, compare, add), widen (e5m2 to
float32), store and sign (the sign algebra, the byte packing or the pair
conversion of the store), tq (the variable total rounded through e5m2),
sums (the float32 sums and ext - |m|), loads and addresses (the gathered
rows' 64-bit offsets, the loads and stores), loop (the node and slot
loops' counters and branches) and prologue. The issue bound is the
instructions of one pass over the general cell (E = 3,145,728 edges, B =
384) at the card's issue rate (``runtime/perf.py``). Needs ``nvcc`` and
``nvdisasm`` (the card's host), not a card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "ldpc_decoder_tpu_torch", "csrc")

# (label, kernel expression, its mangled name's core, D, V, design)
KERNELS = (
    ("cn_e5m2", "ldpc::general::cn_general_e5m2_kernel<6, 8>",
     "22cn_general_e5m2_kernelILi6ELi8E", 6, 8, "threshold lookup"),
    ("vn_e5m2", "ldpc::general::vn_general_e5m2_kernel<3, 16>",
     "22vn_general_e5m2_kernelILi3ELi16E", 3, 16, "threshold lookup"),
    ("cn_fp8_phifast",
     "ldpc::general::cn_general_kernel<__nv_fp8_e5m2, 6, 8, ldpc::PhiFast>",
     "17cn_general_kernelI13__nv_fp8_e5m2Li6ELi8ENS_7PhiFastE", 6, 8,
     "PhiFast (general.cuh)"),
    ("vn_fp8_phifast",
     "ldpc::general::vn_general_kernel<__nv_fp8_e5m2, 3, 16, ldpc::PhiFast>",
     "17vn_general_kernelI13__nv_fp8_e5m2Li3ELi16ENS_7PhiFastE", 3, 16,
     "PhiFast (general.cuh)"),
    ("cn_bf16", "ldpc::general::cn_general_kernel<__nv_bfloat16, 6, 8, "
     "ldpc::PhiFast>", "17cn_general_kernelI13__nv_bfloat16Li6ELi8ENS_7"
     "PhiFastE", 6, 8, "bfloat16, PhiFast"),
    ("vn_bf16", "ldpc::general::vn_general_kernel<__nv_bfloat16, 3, 8, "
     "ldpc::PhiFast>", "17vn_general_kernelI13__nv_bfloat16Li3ELi8ENS_7"
     "PhiFastE", 3, 8, "bfloat16, PhiFast"),
)
# the general cell: make_regular_code(2**20, 3, 6, seed=9) at B = 384
EDGES, B = 3 * 2**20, 384

# helper functions (file, name) -> category; a line inside one takes its
# category, except that a store or widening helper called from a line
# that rounds the variable total belongs to tq
FUNCTIONS = {
    ("common.cuh", "fp8_e5m2_bits"): "tq",
    ("common.cuh", "to_f32"): "widen",
    ("sum_product.cuh", "phi_abs_fast"): "phi",
    ("sum_product.cuh", "ex2_approx"): "phi",
    ("sum_product.cuh", "lg2_approx"): "phi",
    ("sum_product.cuh", "abs"): "phi",
    ("sum_product.cuh", "floor"): "prologue",
    ("sum_product.cuh", "pack"): "store and sign",
    ("sum_product.cuh", "e5m2x2"): "store and sign",
    ("sum_product.cuh", "sign_of"): "store and sign",
    ("sum_product.cuh", "load_pack"): "loads and addresses",
    ("sum_product.cuh", "store_pack"): "loads and addresses",
    ("general.cuh", "source_row"): "loads and addresses",
    ("general.cuh", "load_sources"): "prologue",
    ("general_e5m2.cuh", "phi_e5m2_code"): "phi",
    ("general_e5m2.cuh", "e5m2_bucket"): "phi",
    ("general_e5m2.cuh", "stage_e5m2_table"): "prologue",
    ("general_e5m2.cuh", "load_rows"): "prologue",
    ("general_e5m2.cuh", "load_bytes"): "loads and addresses",
    ("general_e5m2.cuh", "store_bytes"): "loads and addresses",
    ("general_e5m2.cuh", "widen_pair"): "widen",
    ("general_e5m2.cuh", "widen"): "widen",
    ("general_e5m2.cuh", "pack_low_bytes"): "store and sign",
    ("general_e5m2.cuh", "pack_high_bytes"): "store and sign",
}
# a kernel body line -> category, by its text (first match)
LINE_RULES = (
    (r"tot\[|tq2", r"e5m2x2|from_f32|widen_pair", "tq"),
    (r"Phi::abs|phi_e5m2_code", None, "phi"),
    (r"to_f32\(p\.v|widen<V>", None, "widen"),
    (r"Store<|store_pack|store_bytes|__uint_as_float\(__float_as_uint|"
     r"sign_of|X\[|kLaneSigns|pack_", None, "store and sign"),
    (r"ext\[v\] = |tot\[v\] = ", None, "sums"),
    (r"source_row|load_pack|load_bytes|\* out =|out \+|out, o|"
     r"rows\[|\* in =", None, "loads and addresses"),
    (r"for \(|n_here|n0 \+ n|const int i|size_t node", None, "loop"),
)
CATEGORY_ORDER = ("phi", "widen", "store and sign", "tq", "sums",
                  "loads and addresses", "loop", "prologue", "other")


def function_ranges(path: str) -> dict[str, list[tuple[int, int]]]:
    """{function name: [(first line, last line)]} for the definitions in a
    header (a line whose name( is followed by a body), by brace count."""
    lines = open(path).read().splitlines()
    out: dict[str, list[tuple[int, int]]] = {}
    for i, text in enumerate(lines):
        m = re.search(r"\b(\w+)\(", text)
        if m is None or text.lstrip().startswith(("//", "#", "return")):
            continue
        if not re.match(r"\s*(?:template|__|static|constexpr|inline|void|"
                        r"float|uint|int|struct|const|Pack|Bytes)", text):
            continue
        depth, start, j = 0, None, i
        while j < len(lines):
            depth += lines[j].count("{") - lines[j].count("}")
            if "{" in lines[j] and start is None:
                start = j
            if ";" in lines[j] and start is None:
                break
            if start is not None and depth == 0:
                out.setdefault(m.group(1), []).append((i + 1, j + 1))
                break
            j += 1
    return out


def categorize(frames, ranges, texts) -> str:
    """The category of an instruction from its line chain (innermost
    first, each (file, line))."""
    for depth, (path, line) in enumerate(frames):
        name = os.path.basename(path)
        for (fname, func), cat in FUNCTIONS.items():
            if fname != name:
                continue
            if any(a <= line <= b for a, b in ranges.get(path, {}).get(
                    func, [])):
                if cat in ("store and sign", "widen"):
                    outer = [texts(p, ln) for p, ln in frames[depth + 1:]]
                    if any(re.search(LINE_RULES[0][0], t) and re.search(
                            LINE_RULES[0][1], t) for t in outer):
                        return "tq"
                return cat
    text = texts(*frames[-1]) if frames else ""
    for pattern, also, cat in LINE_RULES:
        if re.search(pattern, text) and (also is None
                                         or re.search(also, text)):
            return cat
    return "other"


# where the line information names no line of a category (ptxas puts some
# hoisted instructions on the kernel's first line), the mnemonic's
MNEMONIC_CATEGORIES = (("FADD", "sums"), ("HADD2.F32", "widen"),
                       ("F2FP", "tq"))


def parse(listing: str):
    """{function: [(mnemonic, line chain, branch target label or None)]},
    {function: {label: instruction index}} from nvdisasm output. A chain
    is innermost first: nvdisasm writes one ``//## File`` line for each
    frame before an instruction (the innermost with ``inlined at``), and
    an instruction with none keeps the chain before it."""
    funcs, labels = {}, {}
    name, frames, fresh = None, [], True
    for raw in listing.splitlines():
        text = raw.strip()
        m = re.match(r"\.text\.(\S+?):?$", text) or re.match(
            r"\.section\s+\.text\.(\S+?),", text)
        if m:
            name = m.group(1)
            funcs.setdefault(name, [])
            labels.setdefault(name, {})
            frames, fresh = [], True
            continue
        if name is None:
            continue
        if text.startswith("//## File"):
            pair = re.search(r'"([^"]+)", line (\d+)', text)
            if fresh:
                frames, fresh = [], False
            frames.append((pair.group(1), int(pair.group(2))))
            continue
        m = re.match(r"(\.L\w+):", text)
        if m:
            labels[name][m.group(1)] = len(funcs[name])
            continue
        m = re.match(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", text)
        if m:
            target = re.search(r"`\((\.L\w+)\)", m.group(2))
            funcs[name].append((m.group(1), list(frames),
                                target.group(1) if target else None))
            fresh = True
    return funcs, labels


def loops(ins, labels) -> list[tuple[int, int]]:
    """(first, last) instruction index of each loop: a branch back to a
    label at or before it."""
    out = []
    for i, (op, _, target) in enumerate(ins):
        if op.startswith("BRA") and target in labels and labels[target] <= i:
            out.append((labels[target], i))
    return out


def nodes_per_block(label: str) -> int:
    """A block's nodes at most: general_e5m2.cuh kE5m2Nodes for the
    threshold kernels, general.cuh kNodesPerBlock for the others."""
    header, name = (("general_e5m2.cuh", "kE5m2Nodes") if "e5m2" in label
                    else ("general.cuh", "kNodesPerBlock"))
    text = open(os.path.join(CSRC, header)).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def rows_per_thread(V: int, per_block: int) -> int:
    """Nodes a thread walks at B (general.cuh general_shape, general_e5m2
    .cuh e5m2_shape)."""
    vectors = (B + V - 1) // V
    lanes = min(vectors, 128)
    rows = min(128 // lanes, per_block)
    nodes = rows * (per_block // rows)
    return nodes // rows


def count(ins, labels, D: int, V: int, cats, per_block: int) -> dict:
    spans = loops(ins, labels)
    stores = [i for i, (op, _, _) in enumerate(ins) if op.startswith("STG")]
    inner = [s for s in spans if any(s[0] <= i <= s[1] for i in stores)
             and not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                         for o in spans)]
    assert inner, "no loop that stores"
    pass2 = min(inner, key=lambda s: s[1] - s[0])
    outer = [s for s in spans if s != pass2 and s[0] <= pass2[0]
             and pass2[1] <= s[1]]
    assert outer, "no node loop around the second pass"
    node = min(outer, key=lambda s: s[1] - s[0])
    weight = [0.0] * len(ins)
    messages = D * V
    per_thread = rows_per_thread(V, per_block) * messages
    for i in range(len(ins)):
        if pass2[0] <= i <= pass2[1]:
            weight[i] = D / messages
        elif node[0] <= i <= node[1]:
            weight[i] = 1 / messages
        elif i < node[0]:
            weight[i] = 1 / per_thread
    split = {c: 0.0 for c in CATEGORY_ORDER}
    for w, c in zip(weight, cats):
        split[c] += w
    total = sum(weight)
    from ldpc_decoder_tpu_torch.runtime import perf

    return {
        "instructions": len(ins),
        "pass2_loop": pass2[1] - pass2[0] + 1,
        "node_loop": node[1] - node[0] + 1,
        "prologue": node[0],
        "per_message": round(total, 3),
        "split": {c: round(v, 3) for c, v in split.items() if v},
        "issue_bound_ms": total * EDGES * B / perf.ISSUE_OPS_PER_S * 1e3,
    }


def measure(out_dir: str, check_plain: bool = True) -> dict[str, dict]:
    """{label: record} for every kernel of KERNELS; the listing into
    ``out_dir``. ``check_plain`` compiles the source a second time without
    ``-lineinfo`` and requires the same instructions."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    os.makedirs(out_dir, exist_ok=True)
    nvcc = _kernels._nvcc()
    nvdisasm = os.path.join(os.path.dirname(nvcc), "nvdisasm")
    flags = ["-cubin" if f == "-shared" else f
             for f in _kernels.NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC", "--split-compile=0")]
    source = '#include "general_e5m2.cuh"\n' + "".join(
        f"void* k{i} = reinterpret_cast<void*>(&{expr});\n"
        for i, (_, expr, *_) in enumerate(KERNELS))
    listings = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "general_fp8_sass.cu")
        with open(src, "w") as f:
            f.write(source)
        tags = (("lineinfo", ["-lineinfo"]), ("plain", []))
        for tag, extra in tags if check_plain else tags[:1]:
            cubin = os.path.join(tmp, f"{tag}.cubin")
            subprocess.run([nvcc, *flags, *extra, "-I", CSRC, "-o", cubin,
                            src], check=True, capture_output=True,
                           timeout=600)
            listings[tag] = subprocess.run(
                [nvdisasm, "--print-line-info-inline", "-c", cubin]
                if tag == "lineinfo" else [nvdisasm, "-c", cubin],
                check=True, capture_output=True, text=True,
                timeout=300).stdout
    with open(os.path.join(out_dir, "general_fp8_sass.txt"), "w") as f:
        f.write(listings["lineinfo"])
    return analyze(listings["lineinfo"], listings.get("plain"))


def analyze(listing: str, plain: str | None = None) -> dict[str, dict]:
    """{label: record} from a listing with line information (and, when
    given, the same source's listing without it, whose instructions must
    be the same)."""
    funcs, labels = parse(listing)
    plain_funcs = parse(plain)[0] if plain is not None else None
    ranges: dict[str, dict] = {}
    cache: dict[str, list[str]] = {}

    def texts(path, line):
        if path not in cache:
            try:
                cache[path] = open(path).read().splitlines()
            except OSError:
                cache[path] = []
        lines = cache[path]
        return lines[line - 1] if 0 < line <= len(lines) else ""

    out = {}
    for label, _, core, D, V, design in KERNELS:
        name = next(n for n in funcs if core in n)
        ins = funcs[name]
        if plain_funcs is not None:
            assert [op for op, _, _ in ins] == [
                op for op, _, _ in plain_funcs[name]], \
                f"{label}: -lineinfo changed the instructions"
        for path in {p for _, fr, _ in ins for p, _ in fr}:
            if path not in ranges:
                ranges[path] = (function_ranges(path)
                                if os.path.exists(path) else {})
        cats = [categorize(fr, ranges, texts) for _, fr, _ in ins]
        cats = [next((c for m, c in MNEMONIC_CATEGORIES
                      if op.startswith(m)), cat) if cat == "other" else cat
                for (op, _, _), cat in zip(ins, cats)]
        out[label] = {"kernel": label, "design": design, "function": name,
                      "D": D, "V": V,
                      **count(ins, labels[name], D, V, cats,
                              nodes_per_block(label))}
    return out


def main(argv: list[str]) -> int:
    out_dir = argv[0] if argv else os.path.join(
        HERE, "ldpc_decoder_tpu_torch", "build")
    for rec in measure(out_dir).values():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
