"""Variant generation CLI: SOFA -> converted bank -> synthesized variants.

Capability parity with tools/ss2-spatial-prototype/generate.py
(:41-259): convert a SOFA source (or take a 14-channel WAV directly), analyze
a reference bank for target metrics, then build variant sets:

  core  A-D          original-timing / minimum-phase x ambience intensity
  v2    D @ tone 50/75/100%  D's spatial model over a base tonally projected
                     onto the reference at increasing strength (the spatial
                     topology is seeded identically across the three, so only
                     the tonal conditioning differs)
  v3    phase+diffuse original interaural phase, full tonal/ILD projection,
                     velvet-noise diffuse ambience, and a final tone pass to
                     undo the diffuse addition's broad tilt

Each variant is validated (decay targets, direction levels, tonal bounds)
and written with a provenance manifest.

CLI: python -m airwave_tpu_torch.tools.generate --reference REF.wav
       (--sofa SRC.sofa | --base BASE.wav) --output-dir DIR
       [--sets core v2 v3]

Port of airwave_tpu/tools/generate.py, the same host code: the port keeps
its own copy and imports no module of the JAX package. One difference: main() leaves the process's SIGPIPE disposition
alone (the JAX tool resets it to the default, which makes an embedding
process die on a socket's peer close); only the `__main__` entry does.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

import numpy as np

from airwave_tpu_torch.io import wav as wav_io
from airwave_tpu_torch.tools import spatial
from airwave_tpu_torch.tools.sofa import sha256_file

V2_VARIANTS = (
    ("V2_D_tone50", "D spatial model, 50% reference tone match", 0.5),
    ("V2_D_tone75", "D spatial model, 75% reference tone match", 0.75),
    ("V2_D_tone100", "D spatial model, full reference tone match", 1.0),
)
V3_VARIANT = (
    "V3_phase_diffuse_tone100",
    "Original interaural phase, full tone/ILD match, velvet diffuse ambience",
)
VARIANT_SETS = ("core", "v2", "v3")


def load_bank(path: str) -> np.ndarray:
    data = wav_io.load(path)
    if data.channel_count != 14:
        raise spatial.PrototypeError(
            f"bank WAV has {data.channel_count} channels, need 14"
        )
    return data.audio.T.astype(np.float64)


def _variant_specs(sets: Sequence[str]):
    """Yield (name, description, min_phase, ambience, tone_strength,
    tail_model, seed_name) for every requested set."""
    for requested in sets:
        if requested not in VARIANT_SETS:
            raise spatial.PrototypeError(
                f"unknown variant set {requested!r}; choose from {VARIANT_SETS}"
            )
    if "core" in sets:
        for name, description, min_phase, ambience in spatial.VARIANTS:
            yield name, description, min_phase, ambience, 0.0, "allpass", name
    if "v2" in sets:
        for name, description, strength in V2_VARIANTS:
            # Constant seed name: V2 keeps D's spatial topology fixed and
            # varies only the tonal conditioning strength.
            yield (name, description, True, 1.0, strength, "allpass",
                   "D_minphase_target_space")
    if "v3" in sets:
        yield (V3_VARIANT[0], V3_VARIANT[1], False, 1.0, 1.0, "velvet",
               V3_VARIANT[0])


def _synthesize_one(base, reference_metrics, min_phase, ambience,
                    tone_strength, tail_model, seed, frames):
    conditioned = (
        spatial.condition_to_reference(
            spatial._pad_bank(base, frames), reference_metrics, tone_strength
        )
        if tone_strength > 0 else base
    )
    bank, parameters = spatial.synthesize_variant(
        conditioned, reference_metrics, min_phase, ambience,
        frames=frames, seed=seed, tail_model=tail_model,
        return_parameters=True,
    )
    if tail_model == "velvet" and tone_strength > 0:
        # The time-domain diffuse addition tilts broad magnitude slightly;
        # run one more projection pass without touching timing.
        projected = spatial.condition_to_reference(
            bank.astype(np.float64), reference_metrics, 1.0
        )
        # Re-engage the synthesis peak limiter: the projection can push
        # samples past the 0.98 ceiling synthesize_variant enforced, and
        # the recorded _output parameters must describe the written bank.
        peak = float(np.max(np.abs(projected)))
        if peak > 0.98:
            projected *= 0.98 / peak
        parameters["_output"] = {"peak": peak, "peak_limited": peak > 0.98}
        bank = projected.astype(np.float32)
    return conditioned, bank, parameters


def generate(reference_path: str, base_path: str, output_dir: str,
             seed: int = 20_260_816,
             sets: Sequence[str] = ("core",),
             frames: int = spatial.OUTPUT_FRAMES) -> dict:
    reference_metrics = spatial.analyze_wav(reference_path)
    base = load_bank(base_path)
    os.makedirs(output_dir, exist_ok=True)

    results = []
    for (name, description, min_phase, ambience, tone_strength,
         tail_model, seed_name) in _variant_specs(sets):
        conditioned, bank, parameters = _synthesize_one(
            base, reference_metrics, min_phase, ambience, tone_strength,
            tail_model, f"{seed}|{seed_name}", frames,
        )
        problems = spatial.validate_variant(bank, reference_metrics)
        if ambience > 0:
            problems += spatial.validate_decay(
                bank.astype(np.float64), reference_metrics, ambience,
                late_energy_guard=0.0125 if tone_strength > 0 else 0.01,
            )
        out_path = os.path.join(output_dir, f"{name}.wav")
        wav_io.save(out_path, bank.T, spatial.SAMPLE_RATE)
        results.append({
            "name": name,
            "description": description,
            "minimum_phase": min_phase,
            "ambience_scale": ambience,
            "tone_match_strength": tone_strength,
            "tail_model": tail_model,
            "path": os.path.basename(out_path),
            "sha256": sha256_file(out_path),
            "frames": int(bank.shape[0]),
            "parameters": parameters,
            "validation": {
                "problems": problems,
                "max_tonal_deviation_vs_base_db": spatial.max_tonal_deviation_db(
                    spatial._pad_bank(
                        np.asarray(conditioned, np.float64), frames
                    ),
                    bank.astype(np.float64),
                ),
                "max_reference_tone_error_db": spatial.max_reference_tone_error_db(
                    bank.astype(np.float64), reference_metrics
                ),
                "peak": float(np.max(np.abs(bank))),
            },
        })

    manifest = {
        "schema_version": 2,
        "reference": {
            "path": os.path.basename(reference_path),
            "sha256": sha256_file(reference_path),
        },
        "base": {
            "path": os.path.basename(base_path),
            "sha256": sha256_file(base_path),
        },
        "seed": seed,
        "sets": list(sets),
        "variants": results,
    }
    manifest_path = os.path.join(output_dir, "variants.json")
    with open(manifest_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reference", required=True,
                        help="14-ch reference WAV providing target metrics")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--sofa", help="SOFA source to convert as the base bank")
    group.add_argument("--base", help="14-ch WAV to use as the base bank")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--seed", type=int, default=20_260_816)
    parser.add_argument("--sets", nargs="+", default=["core"],
                        choices=VARIANT_SETS,
                        help="variant sets to build (core, v2, v3)")
    args = parser.parse_args(argv)

    base_path = args.base
    if args.sofa:
        from airwave_tpu_torch.tools.convert import convert_file

        base_path, _ = convert_file(args.sofa, args.output_dir)
    manifest = generate(args.reference, base_path, args.output_dir,
                        args.seed, sets=args.sets)
    bad = [v["name"] for v in manifest["variants"]
           if v["validation"]["problems"]]
    print(json.dumps({"variants": len(manifest["variants"]),
                      "with_problems": bad}))
    return 0


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    raise SystemExit(main())
