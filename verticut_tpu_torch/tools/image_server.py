"""Launch the msgpack-RPC query front-end on the port's engine — the
twin of ``tools/image_server.py`` (the ``image-server`` binary analog,
default port 9191):

    python -m verticut_tpu_torch.tools.image_server --index PATH [--device cpu]

``PATH`` is an ``.npz`` index written by either package's ``save_index``;
it is loaded onto the card unless ``--device`` names another device.
Serves until SIGINT or SIGTERM.
"""

import argparse
import signal


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", required=True)
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("-p", "--port", type=int, default=9191)
    p.add_argument("-k", "--knn", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="device to serve from (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.index.mih import load_index
    from verticut_tpu_torch.service import ImageSearchServer

    # sigwait takes blocked signals; the server's threads inherit the mask
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGINT, signal.SIGTERM})
    index = load_index(args.index, device=args.device)
    srv = ImageSearchServer(index, host=args.ip, port=args.port,
                            default_knn=args.knn).start()
    print(f"serving {index.n} codes on {args.ip}:{srv.port}", flush=True)
    signal.sigwait({signal.SIGINT, signal.SIGTERM})
    srv.stop()


if __name__ == "__main__":
    main()
