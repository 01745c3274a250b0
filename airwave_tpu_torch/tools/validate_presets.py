"""Preset dataset validation gate.

Port of scripts/validate_presets.py with its flags, environment hooks,
output lines and exit codes. It checks that a directory of converted HRIR
WAVs and their manifests is complete and consistent (the count, 14
channels, the manifest's sha256 of the WAV, the loudness target hit), and
that the EqualizerAPO presets of a directory parse. It reads files only and
touches no device, so it takes no --device and runs anywhere.

    python -m airwave_tpu_torch.tools.validate_presets --hrir-dir DIR \\
        [--expected-count N]
    python -m airwave_tpu_torch.tools.validate_presets --eq-dir DIR

Environment overrides (the reference's CI hooks):
AIRWAVE_HRIR_VALIDATION_DIR, AIRWAVE_EXPECTED_HRIR_COUNT. Prints one
`INVALID: ...` line per problem, or `presets valid`; exit 1 on any problem.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys


def validate_hrir_dir(directory: str, expected_count: "int | None") -> list:
    from airwave_tpu_torch.io import wav as wav_io
    from airwave_tpu_torch.tools.convert import front_stereo_binaural_energy
    from airwave_tpu_torch.tools.sofa import sha256_file

    problems = []
    wavs = sorted(glob.glob(os.path.join(directory, "*.wav")))
    manifests = sorted(glob.glob(os.path.join(directory, "*.json")))
    if expected_count is not None:
        if len(wavs) != expected_count:
            problems.append(f"expected {expected_count} WAVs, found {len(wavs)}")
        if len(manifests) != expected_count:
            problems.append(
                f"expected {expected_count} manifests, found {len(manifests)}"
            )
    for wav_path in wavs:
        name = os.path.basename(wav_path)
        try:
            data = wav_io.load(wav_path)
        except Exception as err:  # noqa: BLE001 - every failure is a finding
            problems.append(f"{name}: unreadable ({err})")
            continue
        if data.channel_count != 14:
            problems.append(f"{name}: {data.channel_count} channels != 14")
        manifest_path = os.path.splitext(wav_path)[0] + ".json"
        if not os.path.exists(manifest_path):
            problems.append(f"{name}: missing manifest")
            continue
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("output", {}).get("sha256") != sha256_file(wav_path):
            problems.append(f"{name}: manifest sha256 mismatch")
        cal = manifest.get("loudness_calibration", {})
        target = cal.get("target_front_stereo_binaural_energy")
        if target:
            energy = front_stereo_binaural_energy(data.audio.T)
            if not math.isclose(energy, target, rel_tol=1e-4):
                problems.append(
                    f"{name}: front-stereo energy {energy:.6f} != {target:.6f}"
                )
    return problems


def validate_eq_dir(directory: str) -> list:
    from airwave_tpu_torch.io import apo

    problems = []
    for path in sorted(glob.glob(os.path.join(directory, "*.txt"))):
        name = os.path.basename(path)
        try:
            with open(path, "rb") as f:
                apo.parse(f.read(), name)
        except Exception as err:  # noqa: BLE001 - every failure is a finding
            problems.append(f"{name}: {err}")
    return problems


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hrir-dir",
                        default=os.environ.get("AIRWAVE_HRIR_VALIDATION_DIR"))
    parser.add_argument(
        "--expected-count",
        type=int,
        default=int(os.environ.get("AIRWAVE_EXPECTED_HRIR_COUNT", 0)) or None,
    )
    parser.add_argument("--eq-dir")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    problems = []
    if args.hrir_dir:
        problems += validate_hrir_dir(args.hrir_dir, args.expected_count)
    if args.eq_dir:
        problems += validate_eq_dir(args.eq_dir)
    if not args.hrir_dir and not args.eq_dir:
        parser.error("provide --hrir-dir and/or --eq-dir")

    for problem in problems:
        print(f"INVALID: {problem}")
    if not problems:
        print("presets valid")
    return 1 if problems else 0


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    sys.exit(main())
