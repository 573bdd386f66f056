"""Multi-stream serving: decode N concurrent audio streams on one card.

Twin of examples/multistream_serving.py on the port.  Each stream keeps
the single-stream semantics (replicate-first-frame STC init, 15-frame
delay gate, repeat-last-frame tail flush) while all of them share one
batched block a step: MultiStreamKWS for KWS packages (kernels A or A',
then B, or G on a network B does not take, then F on the card),
MultiStreamRecognizer for the others (A or A', C', D).  The streams are
fed interleaved in 64 KiB chunks, as concurrent sources would arrive;
each file is one stream and the per-stream .rec lines print at the end.

    python -m phnrec_tpu_torch.examples.multistream_serving [--device DEV] [--mesh] PKG_DIR a.raw b.raw [...]

--mesh shards the streams over a DeviceMesh with a "data" dimension, one
process a card (SPMD): under torchrun every rank serves its share and
rank 0 prints every stream's labels; without a launcher it is one
process, world size 1 (NCCL on the card, gloo on the CPU, over a
FileStore).  The ranks used are the most that divide the stream count.
"""

import os
import sys
import tempfile

import torch
import torch.distributed as dist

from phnrec_tpu_torch.examples import split_device
from phnrec_tpu_torch.io.labels import format_rec_line
from phnrec_tpu_torch.multistream import MultiStreamKWS, MultiStreamRecognizer
from phnrec_tpu_torch.pipeline import SpeechRec, resolve_device


def _mesh(device: str, n_streams: int, store_dir: str):
    """(the DeviceMesh of the ranks that serve, whether this rank is one of
    them, whether the process group was created here)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = torch.device(device)
    created = not dist.is_initialized()
    if created:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:          # a launcher: env:// rendezvous
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            if dev.type == "cuda":
                torch.cuda.set_device(resolve_device(dev))
            dist.init_process_group(
                backend, store=dist.FileStore(
                    os.path.join(store_dir, "store"), 1),
                rank=0, world_size=1)
    n_dev = dist.get_world_size()
    while n_streams % n_dev:
        n_dev -= 1
    mesh = DeviceMesh(dev.type, list(range(n_dev)),
                      mesh_dim_names=("data",))
    return mesh, dist.get_rank() < n_dev, created


def main(argv=None) -> int:
    device, args = split_device(argv)
    use_mesh = "--mesh" in args
    args = [a for a in args if a != "--mesh"]
    if len(args) < 2:
        print(__doc__)
        return 1
    pkg, paths = args[0], args[1:]

    with tempfile.TemporaryDirectory() as store_dir:
        mesh, serves, created, lead = None, True, False, True
        if use_mesh:
            mesh, serves, created = _mesh(device, len(paths), store_dir)
            lead = dist.get_rank() == 0
            if lead:
                print(f"# sharding {len(paths)} streams over "
                      f"{mesh.size()} devices")
        try:
            if serves:
                _serve(pkg, paths, device, mesh, lead)
        finally:
            if created:
                dist.destroy_process_group()
    return 0


def _serve(pkg, paths, device, mesh, lead: bool) -> None:
    sr = SpeechRec(pkg, device=device)
    # KWS packages (decoder/type=stkint + mode=kws) get the multi-stream
    # keyword-spotting server; everything else the phoneme server
    kws = sr.stk_decoder is not None and sr.stk_decoder.mode == "kws"
    cls = MultiStreamKWS if kws else MultiStreamRecognizer
    ms = cls(sr, n_streams=len(paths), mesh=mesh)
    chunk = 64 * 1024
    offsets = [0] * len(paths)
    data = [open(p, "rb").read() for p in paths]
    # interleaved feeding, as concurrent sources would arrive
    while any(o < len(d) for o, d in zip(offsets, data)):
        for i, d in enumerate(data):
            if offsets[i] < len(d):
                ms.process(i, d[offsets[i]: offsets[i] + chunk])
                offsets[i] += chunk
            else:
                ms.end_stream(i)
    results = ms.finish()
    if not lead:
        return
    for path, labels in zip(paths, results):
        print(f"# {path}")
        for lab in labels:
            print(format_rec_line(lab))


if __name__ == "__main__":
    sys.exit(main())
