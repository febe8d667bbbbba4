"""Export the reference's LPIPS (AlexNet) weights to the npz schema that
``nvsf_tpu/lib/lpips_jax.py`` loads.

The reference computes LPIPS with the ``lpips`` pip package
(reference ``nvsf/lib/error_matrices.py:164,484``), which downloads
pretrained AlexNet + linear-head weights. Run the conversion on a machine
with network access and ``pip install lpips``, then ship the npz. Schema (see lpips_jax.py):

  conv{i}_w [out, in, kh, kw], conv{i}_b [out]   i in 0..4 (AlexNet trunk)
  lin{i}_w  [1, C_i, 1, 1]                        i in 0..4 (LPIPS heads)

Usage:  python tools/export_lpips_weights.py out.npz
Then:   NVSF_TPU_LPIPS_WEIGHTS=out.npz python -m nvsf_tpu.scripts.main_nvsf ...
"""

import sys


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "lpips_alex.npz"
    try:
        import lpips
    except ImportError:
        raise SystemExit(
            "the `lpips` pip package is not installed here — run this "
            "script on a machine with `pip install lpips torch` and copy "
            "the npz back (zero-egress environments cannot download the "
            "pretrained weights)")
    import numpy as np

    net = lpips.LPIPS(net="alex")
    # AlexNet trunk: lpips wraps torchvision alexnet.features; its conv
    # layers sit at indices 0, 3, 6, 8, 10 (slice1..slice5 in lpips)
    convs = [m for m in net.net.parameters()]  # noqa: F841 (doc only)
    feats = net.net  # lpips.pretrained_networks.alexnet
    slices = [feats.slice1, feats.slice2, feats.slice3, feats.slice4,
              feats.slice5]
    weights = {}
    for i, sl in enumerate(slices):
        conv = [m for m in sl.modules()
                if m.__class__.__name__ == "Conv2d"][0]
        weights[f"conv{i}_w"] = conv.weight.detach().numpy()
        weights[f"conv{i}_b"] = conv.bias.detach().numpy()
    for i, lin in enumerate([net.lin0, net.lin1, net.lin2, net.lin3,
                             net.lin4]):
        conv = [m for m in lin.modules()
                if m.__class__.__name__ == "Conv2d"][0]
        weights[f"lin{i}_w"] = conv.weight.detach().numpy()
    np.savez(out, **weights)
    print(f"wrote {out}: " + ", ".join(
        f"{k}{v.shape}" for k, v in sorted(weights.items())))


if __name__ == "__main__":
    main()
