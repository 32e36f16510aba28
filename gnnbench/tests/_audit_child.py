"""Runs ``gnnbench.run.main`` with its arguments under an audit hook, then prints one
JSON line: the top-level names of every module loaded, and every file path opened."""
import json
import sys

opened = []


def hook(event, args):
    if event == "open" and args and isinstance(args[0], (str, bytes)):
        opened.append(args[0] if isinstance(args[0], str) else args[0].decode())


sys.addaudithook(hook)

from gnnbench import run  # noqa: E402

rc = run.main(sys.argv[1:])
print(json.dumps({"rc": rc, "modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": sorted(set(opened))}))
