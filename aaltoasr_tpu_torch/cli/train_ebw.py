"""train_ebw: discriminative (MMI/MPE) training recipe driver
(`aku/scripts/train_ebw.pl`).

Counterpart of `aaltoasr_tpu/cli/train_ebw.py`, with the same flags plus
``--device`` (default ``cuda``; with no GPU it raises unless ``--device
cpu`` is given).  The EBW iteration loop with the reference's resume
semantics: each iteration runs the discriminative E-step over the
recipe's numerator (hmmnet=) and denominator (den-hmmnet=) networks on
the device, then the EBW M-step with I-smoothing and optional KLD limit
on the host, writing ``BASE_ID_<i>.*`` (skip-if-exists like
train.pl:253-259) and one ``.summary`` line per iteration.  Networks
come from ``make_hmmnets -d`` (create_hmmnets.pl); pass
``--make-hmmnets`` to generate them first.
"""

from __future__ import annotations

import argparse
import os
import sys

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import read_model, write_model
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.train.driver import EStepDriver
from aaltoasr_tpu_torch.train.ebw import estimate_mmi


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="train_ebw")
    p.add_argument("-b", "--base", required=True,
                   help="ML-trained starting model base")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True,
                   help="recipe with hmmnet= and den-hmmnet= fields")
    p.add_argument("-w", "--workdir", required=True)
    p.add_argument("--id", default="ebw", help="BASE_ID for outputs")
    p.add_argument("--criterion", default="mmi",
                   choices=["mmi", "mpe"])
    p.add_argument("--num-iters", type=int, default=4)
    p.add_argument("--C1", type=float, default=2.0)
    p.add_argument("--C2", type=float, default=2.0)
    p.add_argument("--ismooth", type=float, default=100.0,
                   help="I-smoothing tau (train_ebw.pl AC_ISMOOTH)")
    p.add_argument("--limit", type=float, default=0.0,
                   help="KLD limit for parameter change")
    p.add_argument("--minvar", type=float, default=0.1)
    p.add_argument("--make-hmmnets", action="store_true",
                   help="generate num/den networks first "
                        "(make_hmmnets -d)")
    p.add_argument("--lm", help="LM for denominator generation")
    p.add_argument("--lexicon", help="lexicon for den generation")
    p.add_argument("--lm-scale", type=float, default=12.0)
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    if args.make_hmmnets:
        from aaltoasr_tpu_torch.cli.make_hmmnets import main as mh_main
        rc = mh_main(
            ["-b", args.base, "-c", args.config, "-r", args.recipe,
             "-d", "--lm", args.lm or "", "--lexicon",
             args.lexicon or "", "--lm-scale", str(args.lm_scale),
             "--no-force", "-i", str(args.info),
             "--device", args.device])
        if rc != 0:
            return rc

    model = read_model(args.base)
    summary = os.path.join(args.workdir, f"{args.id}.summary")
    for it in range(1, args.num_iters + 1):
        out_base = os.path.join(args.workdir, f"{args.id}_{it}")
        if os.path.exists(out_base + ".ph"):
            model = read_model(out_base)       # resume
            if args.info > 0:
                print(f"Iteration {it}: exists, skipping",
                      file=sys.stderr)
            continue
        driver = EStepDriver(model, args.config, device=device)
        recipe = Recipe.read(args.recipe, args.batch, args.bindex)
        stats = driver.run_recipe(
            recipe, info=max(0, args.info - 1), use_hmmnet=True,
            mmi=args.criterion == "mmi", mpe=args.criterion == "mpe")
        model = estimate_mmi(
            model, driver.table, stats, c1=args.C1, c2=args.C2,
            tau=args.ismooth, minvar=args.minvar,
            mode=args.criterion, max_kld=args.limit)
        write_model(out_base, model)
        crit = (stats.num_ll - stats.den_ll
                if args.criterion == "mmi" else stats.den_ll)
        with open(summary, "a") as f:
            f.write(f"iter {it} criterion {crit:.6g} "
                    f"num_ll {stats.num_ll:.6g} "
                    f"frames {stats.num_frames}\n")
        if args.info > 0:
            print(f"Iteration {it}: criterion {crit:.2f}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
