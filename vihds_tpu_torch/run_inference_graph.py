"""Run an inference graph: its nodes stage by stage, each upstream posterior
propagated into the downstream prior.

The port's ``python -m vihds_tpu.run_inference_graph``, with the same
flags::

  python -m vihds_tpu_torch.run_inference_graph inferencegraphs/demo_graph.yaml \\
      --graph demo [--jobs N]

Each node is a k-fold cross-validation (``call_run_xval.execute``) under
``$INFERENCE_RESULTS_DIR/<graph>/<experiment>_<time>/``.  Before a node
trains, each incoming edge's upstream posterior (the mean of its folds' mu
and the harmonic pool of their precisions) becomes the node's prior for the
edge's target parameter: a LogNormal with that mu and sigma = 1/sqrt(pooled
precision); the node's settings are written to ``propagatedParams.txt``.  A
node whose results directory holds a ``completed.txt`` naming its experiment
is skipped, so a second run resumes.  With ``--jobs N``, nodes of one stage
run side by side in up to N worker processes, started by ``spawn`` (a forked
child cannot use CUDA once its parent has).  Every node runs on the CUDA
device unless ``main`` is given ``device="cpu"``.  A node's ``mesh``,
``mesh_data`` and ``mesh_sample`` work as ``call_run_xval``'s flags in one
process: ``mesh: auto`` trains unsharded (one rank), a factorisation of more
ranks than one stops the node with the JAX package's assertion.
"""

import argparse
import multiprocessing
import os

import numpy as np

from vihds_tpu_torch import config as cfg
from vihds_tpu_torch import inference_graph as ig
from vihds_tpu_torch.call_run_xval import execute as call_run_xval_execute
from vihds_tpu_torch.config import Config, Trainer
from vihds_tpu_torch.utils import resolve_device
from vihds_tpu_torch.utils.attrdict import attrdictify


def create_parser():
    parser = argparse.ArgumentParser(description="VI-HDS inference graph (PyTorch)")
    parser.add_argument("yaml", type=str, help="Name of yaml spec file for the inference graph")
    parser.add_argument(
        "--graph", type=str, default="unnamed",
        help="Name for the inference graph; results root for all nodes",
    )
    parser.add_argument(
        "--jobs", type=int, default=1,
        help="Run up to N same-stage nodes concurrently (process pool)",
    )
    return parser


def pooled_prec(xarr):
    """Harmonic pooling of the folds' precisions."""
    return len(xarr) / sum(1.0 / x for x in xarr)


def propagate_params(node, settings, resultmap):
    """Each incoming edge's upstream posterior (``xval_q_values`` of the
    node named in ``resultmap``) -> the target parameter's prior in
    ``settings``: LogNormal(mu = mean of the folds' mu, sigma = 1/sqrt(pooled
    precision)).  An upstream without a q site of the source parameter
    leaves the edge out, with a warning."""
    for incoming in node.incoming:
        print(
            "Incoming node for %s is %s with parameter %s"
            % (node.name, incoming.source.name, incoming.sourceParam)
        )
        inresultfp = resultmap[incoming.source.name]
        xval = np.load(os.path.join(inresultfp, "xval_q_values.npy"), allow_pickle=True)
        with open(os.path.join(inresultfp, "xval_q_names.txt")) as f:
            xlabels = [line.rstrip() for line in f]
        if incoming.sourceParam + ".mu" not in xlabels:
            print(
                "WARNING: %s has no posterior for %r; skipping edge to %s.%s"
                % (incoming.source.name, incoming.sourceParam, node.name, incoming.targetParam)
            )
            continue
        avgmu = float(np.mean(xval[xlabels.index(incoming.sourceParam + ".mu")]))
        prec = float(pooled_prec(xval[xlabels.index(incoming.sourceParam + ".prec")]))
        sigma = 1.0 / np.sqrt(prec)
        for key in ("global", "local", "shared"):
            if key in settings.params and incoming.targetParam in settings.params[key]:
                print(
                    "Target parameter for %s is %s (%s tier): LogNormal(mu=%.3f, sigma=%.3f)"
                    % (node.name, incoming.targetParam, key, avgmu, sigma)
                )
                settings.params[key][incoming.targetParam] = attrdictify(
                    {"distribution": "LogNormal", "mu": avgmu, "sigma": sigma}
                )


def save_propagated_parameters(params, folder):
    with open(os.path.join(folder, "propagatedParams.txt"), "w") as f:
        f.write(str(params))


def _find_completed(rootpath, node):
    """The results directory of ``node`` under ``rootpath`` whose
    ``completed.txt`` names the node's experiment, or None."""
    if not os.path.isdir(rootpath):
        return None
    for subfolder in os.listdir(rootpath):
        if not subfolder.startswith(node.name):
            continue
        sbpath = os.path.join(rootpath, subfolder)
        completedpath = os.path.join(sbpath, "completed.txt")
        if os.path.isdir(sbpath) and os.path.exists(completedpath):
            with open(completedpath) as f:
                if f.read() == node.args.experiment:
                    return sbpath
    return None


def _run_node(node, resultmap, device):
    settings = Config(node.args)
    settings.trainer = Trainer(node.args, add_timestamp=True)
    propagate_params(node, settings, resultmap)
    save_propagated_parameters(settings.params, settings.trainer.tb_log_dir)
    call_run_xval_execute(node.args, settings, device=device)
    return node.name, settings.trainer.tb_log_dir


def run_graph(graph_name, staged_nodes, jobs=1, device="cuda"):
    """Run the nodes of ``staged_nodes`` (stage -> nodes) stage by stage,
    skipping those already completed; returns {node name: its results
    directory}."""
    device = str(resolve_device(device))
    rootpath = os.path.join(cfg.get_results_directory(), graph_name)
    os.makedirs(rootpath, exist_ok=True)
    resultmap = {}

    for stage in sorted(staged_nodes):
        nodes = staged_nodes[stage]
        print("--- stage %d: %d node(s) ---" % (stage, len(nodes)))
        pending = []
        for node in nodes:
            done = _find_completed(rootpath, node)
            if done is not None:
                print("Node %s already completed." % node.name)
                resultmap[node.name] = done
            else:
                pending.append(node)
        if not pending:
            continue
        if jobs > 1 and len(pending) > 1:
            from concurrent.futures import ProcessPoolExecutor

            with ProcessPoolExecutor(max_workers=jobs,
                                     mp_context=multiprocessing.get_context("spawn")) as ex:
                n = len(pending)
                for name, path in ex.map(_run_node, pending, [resultmap] * n, [device] * n):
                    resultmap[name] = path
        else:
            for node in pending:
                print("Running node %s" % node.name)
                name, path = _run_node(node, resultmap, device)
                resultmap[name] = path
    return resultmap


def main(argv=None, device="cuda"):
    args = create_parser().parse_args(argv)
    graph_map = ig.create_inference_graph(args.yaml, args.graph)
    staged_nodes = ig.arrange_by_stage(graph_map.values())
    return run_graph(args.graph, staged_nodes, jobs=args.jobs, device=device)


if __name__ == "__main__":
    main()
