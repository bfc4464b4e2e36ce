"""The benchmark's plain reference: what the measured program computes,
worked out again in plain PyTorch from the benchmark's own inputs. It
imports nothing of the measured program."""
