"""Released-artifact parity harness of the PyTorch port (counterpart of the
repository's root `parity.py`, which runs the JAX package).

One command validates the port against the reference's released artifacts
(the six `.pt` checkpoints, the Yamaha `data/values_v3/*.npy` caches and
the VGMIDI `song_tokens.npy`, reference ptb_v2.py:336-339, 375-379):

  python -m music_fader_nets_tpu_torch.parity \\
      --from-pt params/music_attr_vae_reg_gmm.pt \\
      --data-dir data/values_v3 --tokens song_tokens.npy [--device cpu]

Runs, in order (each section prints PASS/FAIL and the command exits
nonzero on any failure):

  1. converter round trip: .pt state_dict -> the port's canonical params
     tree -> state_dict, every tensor equal at 1e-6.
  2. forward parity: a torch-functional replica of the reference forward
     paths, built from the SAME state_dict (shapes inferred, nothing
     hard-coded) and run on the CPU in float32, against the port's
     encoders, `sub_decoder_apply` and `global_decoder_teacher` on
     `--device` (CUDA, the kernels, by default) at atol 1e-4. The
     encoders and the teacher decode are checked twice: on dense inputs
     (the generic stacked-GRU kernel) and on one-hot inputs with their
     token ids (the embedded-token encoder and the fused teacher decoder).
  3. Table-1 controllability eval through the port's eval CLI machinery
     (`eval/cli.py::run_evaluation`; the real corpus via --data-dir,
     synthetic stand-ins otherwise).
  4. token-stream re-encode: every row of song_tokens.npy is decoded to
     notes and re-encoded with the port's performance codec; reports the
     exact-match rate and, for rows that differ, the first divergence with
     the token roles on both sides.

The model family is inferred from the checkpoint's file name (--kind
overrides). Sweep mode validates all six released checkpoints of a
directory and prints one summary table (nonzero exit on any MISSING or
FAIL):

  python -m music_fader_nets_tpu_torch.parity --params-dir params/
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch import resolve_device

KINDS = ("singlevae", "vanilla", "gmm", "glsr", "cvae", "fader")

# the six released checkpoints, exactly as named in the reference's
# .MISSING_LARGE_BLOBS manifest (reference README.md:34)
RELEASED_CKPTS = (
    ("music_attr_vae_reg_vanilla.pt", "vanilla"),
    ("music_attr_vae_reg_gmm.pt", "gmm"),
    ("music_attr_vae_reg_glsr.pt", "glsr"),
    ("music_attr_vae_reg_cvae.pt", "cvae"),
    ("music_attr_fader.pt", "fader"),
    ("music_attr_vae_reg_singlevae.pt", "singlevae"),
)

# the JAX harness's input shapes: B=3; the encoders read T=12, the
# sub-decoders 8 steps, the teacher decode 7
B_FWD, T_ENC, T_SUB, T_DEC = 3, 12, 8, 7


def infer_kind(path: str) -> str:
    base = os.path.basename(path).lower()
    for kind in KINDS:               # singlevae before vanilla ("vae" clash)
        if kind in base:
            return kind
    raise SystemExit(f"cannot infer model kind from {path!r}; pass --kind")


def load_state_dict(path: str) -> dict:
    """A `.pt` state_dict of tensors, read with weights_only=True."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state_dict")
    return {k: torch.as_tensor(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# torch-functional replicas of the reference (built from the state_dict,
# shapes inferred; run on the CPU in float32)
# ---------------------------------------------------------------------------


def _torch_gru(sd, prefix):
    w = sd[f"{prefix}.weight_ih_l0"]
    H, I = w.shape[0] // 3, w.shape[1]
    bidir = f"{prefix}.weight_ih_l0_reverse" in sd
    g = torch.nn.GRU(I, H, batch_first=True, bidirectional=bidir)
    g.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()
                       if k.startswith(prefix + ".")})
    return g, H, I


def _lin(sd, prefix, x):
    return F.linear(x, sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])


def _torch_grucell(sd, prefix):
    w = sd[f"{prefix}.weight_ih"]
    H, I = w.shape[0] // 3, w.shape[1]
    c = torch.nn.GRUCell(I, H)
    c.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()
                       if k.startswith(prefix + ".")})
    return c


def _torch_bigru_encode(sd, gru_prefix, mu_prefix, var_prefix, x):
    """Reference encoder path: bi-GRU final states -> mu / exp(var)
    (reference model_v2.py:81-97)."""
    g, _, _ = _torch_gru(sd, gru_prefix)
    h = g(x)[-1].transpose(0, 1).reshape(x.shape[0], -1)
    return _lin(sd, mu_prefix, h), _lin(sd, var_prefix, h).exp()


def _torch_sub_decoder(sd, stream, attr_oh, z):
    """Reference sub-decoder: teacher-forced GRU over [attr_oh, z-repeat],
    h0 = linear_init(z), log_softmax over dim=1 — the reference's TIME-axis
    quirk (model_v2.py:99-116)."""
    g, _, _ = _torch_gru(sd, f"gru_d_{stream}")
    zrep = z.unsqueeze(1).expand(-1, attr_oh.shape[1], -1)
    h0 = _lin(sd, f"linear_init_{stream}", z).unsqueeze(0)
    o = g(torch.cat([attr_oh, zrep], -1), h0)[0]
    return F.log_softmax(_lin(sd, f"linear_out_{stream}", o), 1)


def _torch_teacher_decode(sd, z, x_oh):
    """Reference global_decoder loop, teacher-forced (model_v2.py:118-143)."""
    B, T, V = x_oh.shape
    cell1 = _torch_grucell(sd, "grucell_g")
    cell2 = _torch_grucell(sd, "grucell_g_2")
    out = torch.zeros(B, V)
    out[:, -1] = 1.0
    h1 = _lin(sd, "linear_init_global", z)
    h2 = None
    logps = []
    for i in range(T):
        h1 = cell1(torch.cat([out, z], 1), h1)
        h2 = h1 if i == 0 else h2
        h2 = cell2(h1, h2)
        logps.append(F.log_softmax(_lin(sd, "linear_out_g", h2), 1))
        out = x_oh[:, i]
    return torch.stack(logps, 1)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------


def check_roundtrip(sd) -> bool:
    from music_fader_nets_tpu_torch.utils.checkpoint import (
        convert_torch_state_dict, params_to_torch_state_dict,
    )
    back = params_to_torch_state_dict(convert_torch_state_dict(sd))
    ok = set(sd) == set(back)
    if not ok:
        print("  key sets differ:", set(sd) ^ set(back))
    for k in sorted(set(sd) & set(back)):    # report FAIL, don't KeyError
        ref, got = sd[k].to(torch.float32), back[k]
        if ref.shape != got.shape or not torch.allclose(ref, got, rtol=0,
                                                        atol=1e-6):
            d = (float((ref - got).abs().max()) if ref.shape == got.shape
                 else float("inf"))
            print(f"  mismatch at {k}: max|d|={d:.3g}")
            ok = False
    print(f"[1] converter round trip ({len(sd)} tensors):",
          "PASS" if ok else "FAIL")
    return ok


def check_forward(sd, kind: str, device=None, atol: float = 1e-4,
                  diffs=None) -> bool:
    """Section 2; `diffs`, when a dict, receives max|d| per check."""
    from music_fader_nets_tpu_torch import models
    from music_fader_nets_tpu_torch.models.modules import (
        global_decoder_teacher, sub_decoder_apply,
    )
    from music_fader_nets_tpu_torch.models.vae import (
        _global_view, _sub_view,
    )
    from music_fader_nets_tpu_torch.utils.checkpoint import (
        convert_torch_state_dict, tree_to,
    )

    dev = resolve_device(device)
    sd = {k: v.to(torch.float32) for k, v in sd.items()}
    params = tree_to(convert_torch_state_dict(sd), dev)
    torch.manual_seed(0)
    ok = True

    def on(t):
        return t.to(dev)

    def close(name, got, ref):
        nonlocal ok
        d = float((got.detach().cpu() - ref.detach()).abs().max())
        good = d <= atol
        ok = ok and good
        if diffs is not None:
            diffs[name] = d
        print(f"  {name}: max|d|={d:.2e}", "" if good else f"> {atol} FAIL")

    def one_hot_ids(n_cls, T):
        ids = torch.randint(0, n_cls, (B_FWD, T))
        return F.one_hot(ids, n_cls).float(), ids

    def encoders(encode, streams, x, tokens=None, tag=""):
        """encode(x_dev, tokens_dev) -> [(mu, std)] per stream; streams:
        [(suffix, gru, mu, var prefixes)]; the replica reads x."""
        got = encode(on(x), None if tokens is None else on(tokens))
        for (suffix, g, m, v), (mu, std) in zip(streams, got):
            mu_t, std_t = _torch_bigru_encode(sd, g, m, v, x)
            close(f"encoder mu{suffix}{tag}", mu, mu_t)
            close(f"encoder std{suffix}{tag}", std, std_t)

    with torch.no_grad():
        if kind in ("vanilla", "glsr", "gmm"):
            V = sd["gru_r.weight_ih_l0"].shape[1]
            streams = [("_r", "gru_r", "mu_r", "var_r"),
                       ("_n", "gru_n", "mu_n", "var_n")]

            def encode(x, tok):
                return models.reg_vae_encode(params, x, tokens=tok)
        elif kind == "singlevae":
            V = sd["gru.weight_ih_l0"].shape[1]
            streams = [("", "gru", "mu", "var")]

            def encode(x, tok):
                return [models.single_vae_encode(params, x, tokens=tok)]
        elif kind == "cvae":
            V = sd["gru_e.weight_ih_l0"].shape[1] - 2   # + 2 conditions
        else:                                           # fader
            V = sd["gru_e.weight_ih_l0"].shape[1]
            streams = [("", "gru_e", "mu", "var")]

            def encode(x, tok):
                return [models.fader_encode(params, x, tokens=tok)]

        x = torch.randn(B_FWD, T_ENC, V)
        if kind == "cvae":
            # the encoder reads [x, densities]: no token-id form exists
            rd, nd = torch.rand(B_FWD, 1), torch.rand(B_FWD, 1)
            mu, std = models.cvae_encode(params, on(x), on(rd), on(nd))
            cond = torch.cat([rd, nd], -1).unsqueeze(1).expand(-1, T_ENC, -1)
            mu_t, std_t = _torch_bigru_encode(
                sd, "gru_e", "mu", "var", torch.cat([x, cond], -1))
            close("encoder mu", mu, mu_t)
            close("encoder std", std, std_t)
        else:
            encoders(encode, streams, x)
            x_oh, ids = one_hot_ids(V, T_ENC)
            encoders(encode, streams, x_oh, ids, " (token ids)")

        if kind in ("vanilla", "glsr", "gmm"):
            Z = sd["mu_r.weight"].shape[0]
            for s in ("r", "n"):
                dims = sd[f"linear_out_{s}.weight"].shape[0]
                z = torch.randn(B_FWD, Z)
                a, _ = one_hot_ids(dims, T_SUB)
                got = sub_decoder_apply(_sub_view(params, s), on(a), on(z),
                                        True)
                close(f"sub_decoder_{s}", got,
                      _torch_sub_decoder(sd, s, a, z))

        # the global decoder is common to every family
        zt = sd["linear_init_global.weight"].shape[1]
        V = sd["linear_out_g.weight"].shape[0]
        z = torch.randn(B_FWD, zt)
        x_oh, ids = one_hot_ids(V, T_DEC)
        ref = _torch_teacher_decode(sd, z, x_oh)
        gview = _global_view(params)
        close("global teacher decode",
              global_decoder_teacher(gview, on(z), on(x_oh)), ref)
        close("global teacher decode (token ids)",
              global_decoder_teacher(gview, on(z), on(x_oh),
                                     tokens=on(ids)), ref)

        if kind == "gmm":
            for tbl in ("mu_r_lookup", "mu_n_lookup",
                        "logvar_r_lookup", "logvar_n_lookup"):
                if f"{tbl}.weight" in sd:
                    close(f"mixture table {tbl}", params[tbl],
                          sd[f"{tbl}.weight"])

    print(f"[2] forward parity vs torch replica ({kind}, {dev.type}):",
          "PASS" if ok else "FAIL")
    return ok


def run_table1_eval(kind: str, args) -> bool:
    from music_fader_nets_tpu_torch.eval.cli import run_evaluation
    argv = ["--from-pt", args.from_pt, "--synthetic-size",
            str(args.synthetic_size)]
    for flag, value in (("--data-dir", args.data_dir),
                        ("--device", args.device),
                        ("--config", args.config),
                        ("--samples", args.samples),
                        ("--eval-epochs", args.eval_epochs),
                        ("--decode-steps", args.decode_steps)):
        if value:
            argv += [flag, str(value)]
    try:
        run_evaluation(kind, f"parity Table-1 eval ({kind})", argv=argv)
        print("[3] Table-1 eval at reference workloads: PASS (scores above)")
        return True
    except Exception as e:                     # surface, don't swallow
        print(f"[3] Table-1 eval: FAIL ({e!r})")
        return False


def check_token_stream(tokens_path: str, limit: int) -> bool:
    """Decode -> re-encode every row of the released token array and
    compare (reference ptb_v2.py:375-379 fixture; the codec must reproduce
    the Magenta fork's stream)."""
    from music_fader_nets_tpu_torch.tokenizer.performance_codec import (
        EOS, performance_decode, performance_encode, token_role,
    )

    def fmt(window):
        return " ".join(f"{t}:{token_role(t)}" for t in window)

    rows = np.load(tokens_path, allow_pickle=True)
    n = len(rows) if limit <= 0 else min(limit, len(rows))
    exact, first_bads = 0, []
    role_mismatch = {}
    for i in range(n):
        toks = [int(t) for t in np.asarray(rows[i]).ravel()]
        while toks and toks[-1] == 0:
            toks.pop()                          # strip pad tail
        if toks and toks[-1] == EOS:
            toks.pop()
        back = performance_encode(performance_decode(toks))
        if back == toks:
            exact += 1
            continue
        k = next((j for j in range(min(len(back), len(toks)))
                  if back[j] != toks[j]), min(len(back), len(toks)))
        ref_t = toks[k] if k < len(toks) else None
        got_t = back[k] if k < len(back) else None
        kind = (f"{token_role(ref_t) if ref_t is not None else 'END'}"
                " -> "
                f"{token_role(got_t) if got_t is not None else 'END'}")
        role_mismatch[kind] = role_mismatch.get(kind, 0) + 1
        if len(first_bads) < 3:
            first_bads.append((i, k, len(toks), len(back),
                               toks[max(0, k - 3): k + 4],
                               back[max(0, k - 3): k + 4]))
    rate = exact / max(n, 1)
    print(f"[4] token-stream re-encode: {exact}/{n} rows exact "
          f"({100 * rate:.2f}%)")
    for i, k, lt, lb, a, b in first_bads:
        print(f"  row {i} diverges at pos {k} (ref len {lt}, ours {lb}):\n"
              f"    ref  ... {fmt(a)} ...\n"
              f"    ours ... {fmt(b)} ...")
    if role_mismatch:
        top = sorted(role_mismatch.items(), key=lambda kv: -kv[1])[:6]
        print("  divergence histogram (ref-role -> our-role at first "
              "divergence): "
              + ", ".join(f"{k} x{v}" for k, v in top))
    ok = rate == 1.0
    print("[4]", "PASS" if ok else "FAIL")
    return ok


def run_sweep(args) -> bool:
    """--params-dir mode: find the six released checkpoint names under the
    directory, run the converter round trip and the forward parity (and
    the Table-1 eval unless --skip-eval) for each, then print ONE summary
    table. A missing checkpoint or any failing section fails the sweep;
    an unreadable checkpoint marks its own row FAIL and the sweep goes on."""
    rows = []
    for fname, kind in RELEASED_CKPTS:
        path = os.path.join(args.params_dir, fname)
        print(f"\n=== {kind}: {fname} ===")
        if not os.path.exists(path):
            print("MISSING")
            rows.append((kind, fname, None, None, None))
            continue
        try:
            sd = load_state_dict(path)
            rt = check_roundtrip(sd)
            fw = check_forward(sd, kind, args.device)
            ev = None
            if not args.skip_eval:
                args.from_pt = path    # run_table1_eval reads it from args
                ev = run_table1_eval(kind, args)
        except Exception as e:
            print(f"ERROR validating {fname}: {type(e).__name__}: {e}")
            rt, fw, ev = False, False, None
        rows.append((kind, fname, rt, fw, ev))

    def cell(v):
        return "-" if v is None else ("PASS" if v else "FAIL")

    ok = True
    print("\nsweep summary:")
    print(f"{'kind':<10} {'checkpoint':<34} {'roundtrip':<10} "
          f"{'forward':<8} table1")
    for kind, fname, rt, fw, ev in rows:
        missing = rt is None and fw is None
        ok = ok and not missing and bool(rt) and bool(fw) and ev is not False
        first = "MISSING" if missing else cell(rt)
        print(f"{kind:<10} {fname:<34} {first:<10} {cell(fw):<8} {cell(ev)}")
    print("sweep:", "ALL PASS" if ok else "FAILURES PRESENT")
    return ok


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m music_fader_nets_tpu_torch.parity",
        description=__doc__.split("\n")[0])
    ap.add_argument("--from-pt", default=None,
                    help="released reference .pt checkpoint")
    ap.add_argument("--params-dir", default=None,
                    help="sweep mode: directory holding the six released "
                         ".pt checkpoints; validates each and prints one "
                         "summary table (mutually exclusive with --from-pt)")
    ap.add_argument("--kind", default=None, choices=KINDS)
    ap.add_argument("--data-dir", default=None,
                    help="real corpus cache dir (data/values_v3 schema)")
    ap.add_argument("--tokens", default=None,
                    help="released song_tokens.npy for codec parity")
    ap.add_argument("--token-limit", type=int, default=0,
                    help="check only the first N token rows (0 = all)")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--synthetic-size", type=int, default=2048)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the port runs: cuda (default; an error "
                         "without a card) with its kernels, or cpu with "
                         "their plain versions; the replica always runs "
                         "on the CPU")
    ap.add_argument("--config", default=None,
                    help="model config JSON for the Table-1 eval (default: "
                         "the family's reference config)")
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--eval-epochs", type=int, default=None)
    ap.add_argument("--decode-steps", type=int, default=None)
    return ap


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.params_dir and args.from_pt:
        ap.error("--params-dir and --from-pt are mutually exclusive")
    if not args.from_pt and not args.tokens and not args.params_dir:
        ap.error("nothing to do: pass --from-pt, --params-dir and/or "
                 "--tokens")

    results = []
    if args.params_dir:            # NB: run_sweep reuses args.from_pt per
        results.append(run_sweep(args))  # checkpoint — hence the elif
    elif args.from_pt:
        kind = args.kind or infer_kind(args.from_pt)
        print(f"checkpoint: {args.from_pt} (kind={kind})")
        sd = load_state_dict(args.from_pt)
        results.append(check_roundtrip(sd))
        results.append(check_forward(sd, kind, args.device))
        if not args.skip_eval:
            results.append(run_table1_eval(kind, args))
    if args.tokens:
        results.append(check_token_stream(args.tokens, args.token_limit))

    print("PARITY:", "ALL PASS" if all(results) else "FAILURES PRESENT")
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
