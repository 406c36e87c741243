"""Advisor CLI: the paper's provisioning questions from the command line,
answered for H100 clusters (counterpart of repro/launch/advisor.py).

  PYTHONPATH=src python -m repro_torch.launch.advisor --arch llama3-405b \
      --batch 128 --seq 32768 --sla-ms 20
  PYTHONPATH=src python -m repro_torch.launch.advisor --arch mixtral-8x22b \
      --power-kw 250
  PYTHONPATH=src python -m repro_torch.launch.advisor \
      --arch internlm2-1.8b --sla-ms 20 --compare-host

The model is arithmetic on the datasheet rows: it runs on any host and
touches no device.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import advisor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--sla-ms", type=float)
    ap.add_argument("--power-kw", type=float)
    ap.add_argument("--compare-host", action="store_true",
                    help="paper Fig. 3 today: H100 vs DDR5-host cluster")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    wl = advisor.lm_decode_workload(cfg, args.batch, args.seq)
    print(f"# {args.arch} decode: batch={args.batch} seq={args.seq}")
    print(f"  resident bytes (params+cache): {wl.db_size/1e9:.1f} GB; "
          f"touched per token: {wl.bytes_accessed/1e9:.1f} GB "
          f"({wl.percent_accessed*100:.1f}%)")

    if args.sla_ms:
        a = advisor.advise_decode_sla(cfg, args.batch, args.seq,
                                      args.sla_ms / 1e3)
        print(f"  SLA {args.sla_ms:g} ms ->")
        print(json.dumps(a.summary(), indent=2, default=float))
    if args.power_kw:
        a = advisor.advise_power(cfg, args.batch, args.seq,
                                 args.power_kw * 1e3)
        print(f"  power budget {args.power_kw:g} kW ->")
        print(json.dumps(a.summary(), indent=2, default=float))
    if not args.sla_ms and not args.power_kw:
        a = advisor.advise_capacity(cfg, args.batch, args.seq)
        print("  capacity-provisioned ->")
        print(json.dumps(a.summary(), indent=2, default=float))
    if args.compare_host:
        print("  when-to-use (H100 vs DDR5 host):")
        for row in advisor.when_to_use_accelerator(cfg, args.batch,
                                                   args.seq):
            print(f"    SLA {row['sla_ms']:6.1f} ms: h100 "
                  f"{row['accel_power_kw']:9.1f} kW vs host "
                  f"{row['host_power_kw']:9.1f} kW -> "
                  f"{'H100' if row['accel_wins_power'] else 'host'}")


if __name__ == "__main__":
    main()
