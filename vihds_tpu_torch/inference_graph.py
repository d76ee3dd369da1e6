"""Inference-graph DAG: a YAML graph of experiments with parameter
propagation (``vihds_tpu.inference_graph`` in PyTorch's package).

Nodes carry ``run_xval`` CLI arguments, edges carry (sourceParam ->
targetParam) prior propagation, a node's stage is its longest path from a
root, and nodes of one stage are independent of each other.
"""

import yaml

from vihds_tpu_torch import run_xval as rxval
from vihds_tpu_torch.utils.attrdict import attrdictify


class Edge:
    def __init__(self, source, sourceParam, target, targetParam):
        self.source = source
        self.sourceParam = sourceParam
        self.target = target
        self.targetParam = targetParam


_NODE_ARG_KEYS = (
    "seed",
    "train_samples",
    "test_samples",
    "epochs",
    "test_epoch",
    "plot_epoch",
    "gpu",
    "folds",
    "precision_hidden_layers",
    "checkpoint_epoch",
    "mesh",
    "mesh_data",
    "mesh_sample",
    "grad_clip_norm",
    "q_global_init",
)

#: store_true CLI flags: a truthy YAML value turns the flag on
_NODE_FLAG_KEYS = ("vmap_folds", "dreg", "verbose")


def process_node_args(name, yamlargs, graph_name):
    """The node's CLI arguments, parsed by the port's ``run_xval`` parser;
    the experiment is ``<graph_name>/<experiment>``."""
    argarr = []
    with_split = "split" in yamlargs or "heldout" in yamlargs
    if "split" in yamlargs:
        argarr.append("--split=" + str(yamlargs["split"]))
    elif "heldout" in yamlargs:
        argarr.append("--heldout=" + str(yamlargs["heldout"]))
    if "spec" in yamlargs:
        argarr.append(yamlargs["spec"])
    else:
        raise ValueError("Node " + name + " missing spec property")
    if "experiment" in yamlargs:
        argarr.append("--experiment=" + graph_name + "/" + yamlargs["experiment"])
    else:
        raise ValueError("Node " + name + " missing experiment property")
    for key in _NODE_ARG_KEYS:
        if key in yamlargs:
            argarr.append("--%s=%s" % (key, yamlargs[key]))
    for key in _NODE_FLAG_KEYS:
        if yamlargs.get(key):
            argarr.append("--" + key)
    return rxval.create_parser(with_split).parse_args(argarr)


class Node:
    def __init__(self, name, yamlargs, graph_name):
        self.name = name
        self.stage = None
        self.incoming = []
        self.outgoing = []
        self.args = process_node_args(name, yamlargs, graph_name)

    def addIncomingEdge(self, edge):
        self.incoming.append(edge)

    def addOutgoingEdge(self, edge):
        self.outgoing.append(edge)

    def setStage(self, stage):
        self.stage = stage


def set_stage(node):
    """node.stage = the longest path to it from any root."""
    if node.stage is not None:
        return
    if not node.incoming:
        node.setStage(0)
        return
    stage = 0
    for incoming in node.incoming:
        if incoming.source.stage is None:
            set_stage(incoming.source)
        stage = max(stage, incoming.source.stage)
    node.setStage(stage + 1)


def create_inference_graph(graphyml, graph_name):
    """{node name: Node} of the graph in the YAML file ``graphyml``, with
    its edges and stages."""
    with open(graphyml, "r") as f:
        graph = attrdictify(yaml.safe_load(f))
    nodemap = {}
    for key in graph.nodes.keys():
        nodemap[key] = Node(key, graph.nodes[key], graph_name)
    for edge in graph.edges:
        source = nodemap[edge["from"]["node"]]
        target = nodemap[edge["to"]["node"]]
        e = Edge(source, edge["from"]["parameter"], target, edge["to"]["parameter"])
        source.addOutgoingEdge(e)
        target.addIncomingEdge(e)
    for node in nodemap.values():
        set_stage(node)
    return nodemap


def arrange_by_stage(nodes):
    """stage -> the nodes that can run side by side at that stage."""
    stagemap = {}
    for node in nodes:
        stagemap.setdefault(node.stage, []).append(node)
    return stagemap
