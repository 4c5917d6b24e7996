"""CLI entry point; mirror of tfimm_tpu/train/run_local.py.

Usage: python -m tfimm_tpu_torch.train.run_local --trainer_class=Trainer ...
"""

from tfimm_tpu_torch.train.train import run


def main():
    run(cfg={}, parse_cmdline_args=True)


if __name__ == "__main__":
    main()
