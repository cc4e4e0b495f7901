"""Command-line interface of the port.

Port of simplepanorama_tpu/cli.py: construct a panorama from image
paths, stitch with a config, write the preview or the full-resolution
panorama. Every pan::config field is a flag; a config file in the
reference's key=value format can be read and written; a directory
argument expands to the images inside it; ``--save-state`` /
``--from-state`` checkpoint the post-BA state and resume compositing
from it. One flag is the port's own: ``--device`` (default ``cuda``),
the device every stage runs on; with ``cuda`` and no GPU it raises, as
``Panorama`` does.

    python -m simplepanorama_tpu_torch.cli views/ -o pano.jpg
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from pathlib import Path

from simplepanorama_tpu_torch.config import (
    Blending, Config, Projection, Stretch, read_config_file,
    write_config_file)


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    c = Config()
    p.add_argument("--config", help="key=value config file (reference format)")
    p.add_argument("--save-config", help="write the effective config here")
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--init-size", type=int, default=None,
                   help=f"working resolution max side (default {c.init_size})")
    p.add_argument("--blend", choices=[b.name for b in Blending], default=None)
    p.add_argument("--proj", choices=[b.name for b in Projection], default=None)
    p.add_argument("--stretching", choices=[b.name for b in Stretch],
                   default=None)
    for name, flag in [("gain_compensation", "--gain"),
                       ("blend_intensity", "--blend-intensity"),
                       ("cut", "--graph-cut"),
                       ("cut_seams", "--cut-seams"),
                       ("straighten", "--straighten"),
                       ("fix_center", "--fix-center"),
                       ("fast", "--fast")]:
        g = p.add_mutually_exclusive_group()
        g.add_argument(flag, dest=name, action="store_true", default=None)
        g.add_argument(flag.replace("--", "--no-"), dest=name,
                       action="store_false", default=None)
    for name, typ in [("bands", int), ("sigma_blend", float),
                      ("focal", float), ("lambda_", float),
                      ("max_images_per_match", int), ("max_keypoints", int),
                      ("RANSAC_iterations", int), ("x_margin", int),
                      ("min_overlap", float), ("overlap_inl_match", float),
                      ("overlap_inl_keyp", float), ("conf", float),
                      ("nfeatures", int), ("nOctaveLayers", int),
                      ("contrastThreshold", float), ("edgeThreshold", float),
                      ("sigma_sift", float)]:
        p.add_argument(f"--{name.replace('_', '-').rstrip('-')}",
                       dest=name, type=typ, default=None)


def _build_config(args) -> Config:
    cfg = Config()
    if args.config:
        cfg = read_config_file(args.config, cfg)
    for f in vars(args):
        if hasattr(cfg, f) and getattr(args, f) is not None:
            val = getattr(args, f)
            cur = getattr(cfg, f)
            if isinstance(cur, Blending):
                val = Blending[val] if isinstance(val, str) else val
            elif isinstance(cur, Projection):
                val = Projection[val] if isinstance(val, str) else val
            elif isinstance(cur, Stretch):
                val = Stretch[val] if isinstance(val, str) else val
            setattr(cfg, f, val)
    return cfg


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="panotpu-torch",
        description="Panorama stitcher, PyTorch/CUDA port")
    p.add_argument("images", nargs="*",
                   help="input image paths (a directory expands to the "
                        "image files inside it, like the reference's "
                        "Open Folder); optional with --from-state")
    p.add_argument("-o", "--output", default="panorama.jpg")
    p.add_argument("--full-res", action="store_true",
                   help="render at full input resolution (default: preview)")
    p.add_argument("--crop", type=int, nargs=4, metavar=("X", "Y", "W", "H"),
                   help="crop ROI in preview coordinates")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--timing", action="store_true",
                   help="print the per-stage timing report after stitching")
    p.add_argument("--save-state",
                   help="checkpoint the post-BA stitch state here (resume "
                        "later with --from-state, skipping features/"
                        "matching/BA)")
    p.add_argument("--from-state",
                   help="resume compositing from a --save-state checkpoint "
                        "(blend/projection/seam flags apply fresh; "
                        "features/matching/BA are skipped)")
    p.add_argument("--device", default="cuda",
                   help="torch device every stage runs on (default cuda; "
                        "cpu only when asked for)")
    _add_config_flags(p)
    return p


def _expand_dirs(images):
    """Directory arguments expand to the image files inside (the GTK
    app's File > Open Folder, _create_menu.cpp:open_folder)."""
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}
    inputs = []
    for a in images:
        pa = Path(a)
        if pa.is_dir():
            inputs.extend(sorted(
                str(f) for f in pa.iterdir()
                if f.suffix.lower() in exts and f.is_file()))
        else:
            inputs.append(a)
    return inputs


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = _build_config(args)
    if args.save_config:
        write_config_file(args.save_config, cfg)
    args.images = _expand_dirs(args.images)
    if len(args.images) < 2 and not args.from_state:
        print("error: need at least two input images", file=sys.stderr)
        return 1

    from simplepanorama_tpu_torch.pipeline import Panorama

    def report(frac, text):
        if not args.quiet:
            print(f"\r[{frac:5.1%}] {text:<28}", end="", flush=True)

    t0 = time.time()
    if args.from_state:
        # resume compositing from a checkpoint: blend/proj/seam flags
        # apply fresh; features/matching/BA never re-run
        pano = Panorama.from_state(args.from_state, args.images or None,
                                   cfg, progress=report, device=args.device)
        if not args.quiet:
            print(f"resumed {pano.connected[0]} of {pano.connected[1]} "
                  f"images from {args.from_state} "
                  f"in {time.time() - t0:.1f}s")
        if args.save_state:
            pano.save_state(args.save_state)
        return _render_and_write(args, pano)
    pano = Panorama(args.images, progress=report, device=args.device)

    # interactive cancel: first Ctrl-C flips the pipeline's cancel token
    # (the GTK app's cancel button -> atomic cancel_var,
    # _image_viewer.cpp:45-73); a second Ctrl-C force-exits
    prev_handler = signal.getsignal(signal.SIGINT)

    def on_sigint(signum, frame):
        if pano.cancel_token.cancelled():
            raise KeyboardInterrupt
        print("\ncancelling... (Ctrl-C again to force quit)",
              file=sys.stderr)
        pano.cancel()

    signal.signal(signal.SIGINT, on_sigint)
    try:
        pano.stitch(cfg)
    except RuntimeError as e:
        if "cancel" in str(e).lower():
            print("canceled", file=sys.stderr)
            return 130
        raise
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    if not args.quiet:
        print(f"\nconnected {pano.connected[0]} of {pano.connected[1]} "
              f"images in {time.time() - t0:.1f}s")
    if args.save_state:
        pano.save_state(args.save_state)
        if not args.quiet:
            print(f"saved stitch state to {args.save_state}")
    return _render_and_write(args, pano)


def _render_and_write(args, pano) -> int:
    from simplepanorama_tpu_torch.io import save_image
    if args.full_res:
        out = pano.get_panorama(tuple(args.crop) if args.crop else None)
    else:
        out = pano.get_preview()
        if args.crop:
            x, y, w, h = args.crop
            out = out[y:y + h, x:x + w]
    if args.timing:   # after rendering so render_preview/full are included
        from simplepanorama_tpu_torch.utils.timing import global_timer
        print(global_timer().report())
    if not save_image(args.output, out):
        print(f"error: could not write {args.output}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"wrote {args.output} ({out.shape[1]}x{out.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
