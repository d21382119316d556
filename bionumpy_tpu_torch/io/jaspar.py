"""JASPAR / CSV motif reading (the port's copy of
bionumpy_tpu/io/jaspar.py)."""
from __future__ import annotations

from ..sequence.position_weight_matrix import PWM


def parse_jaspar_line(line: str):
    letter, rest = line.split(maxsplit=1)
    rest = rest.strip()[1:-1].split()
    return letter.strip(), [float(n) for n in rest]


def read_jaspar_matrix(filename: str) -> PWM:
    with open(filename) as f:
        _ = f.readline()
        pwm = dict(parse_jaspar_line(line) for line in f if line.strip())
    return PWM.from_dict(pwm)


def read_csv_motif(filename: str) -> PWM:
    with open(filename) as f:
        alphabet = f.readline().strip().split(",")
        pwm = {letter: [] for letter in alphabet}
        for line in f:
            parts = line.strip().split(",")
            for i, letter in enumerate(alphabet):
                pwm[letter].append(float(parts[i]))
    return PWM.from_dict(pwm)
