"""ResNet v1 through the port's ComputationGraph (`models.zoo.resnet`)."""
from __future__ import annotations

from ..reference import resnet as reference


def build(config, seed, device):
    """The port's network for `config`, on `device`; `seed` seeds the
    program's own generators."""
    from deeplearning4j_tpu_torch.models.zoo import resnet as zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    fixed = {"stages": [list(s) for s in zoo.STAGES],
             "expansion": zoo.EXPANSION, "stem_width": 64,
             "weight_decay": 0.0}
    for key, value in fixed.items():
        if config[key] != value:
            raise ValueError(f"the port's resnet50_conf builds {key}={value}"
                             f", the configuration asks for {config[key]}")
    conf = zoo.resnet50_conf(
        height=config["height"], width=config["width"],
        channels=config["channels"], num_classes=config["num_classes"],
        seed=seed, learning_rate=config["learning_rate"],
        updater=config["updater"], momentum=config["momentum"],
        data_type=config["data_type"])
    return ComputationGraph(conf, device=device).init()


def params_tree(config, host):
    """{(vertex, name): numpy} as `from_jax_params` takes it."""
    tree = {}
    for (vertex, name), a in host.items():
        tree.setdefault(vertex, {})[name] = a
    return tree


def state_tree(running):
    """{vertex: (mean, var)} as `load_reference_model_state` takes it."""
    return {bn: {"mean": m.cpu().numpy(), "var": v.cpu().numpy()}
            for bn, (m, v) in running.items()}


def leaf_items(tree):
    """((vertex, name), array) of a per-vertex tree from the port."""
    for vertex, per in tree.items():
        for name, a in per.items():
            yield (vertex, name), a
