"""VGG through the port's MultiLayerNetwork (`models.zoo.classic_cnns`)."""
from __future__ import annotations

from ..reference import vgg as reference


def build(config, seed, device):
    """The port's network for `config`, on `device`; `seed` seeds the
    program's own generators (dropout's among them)."""
    from deeplearning4j_tpu_torch.models.zoo import classic_cnns as zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    plan = [list(p) for p in zoo._VGG16_PLAN]
    if (config["plan"] != plan or config["dense"] != [4096, 4096]
            or config["dropout_keep"] != 0.5):
        raise ValueError("the port's vgg16_conf builds the plan "
                         f"{plan}, dense [4096, 4096], dropout 0.5")
    if (config["updater"] != "nesterovs" or config["momentum"] != 0.9
            or config["weight_decay"] != 0.0):
        raise ValueError("the port's vgg16_conf trains with Nesterov, "
                         "momentum 0.9, no weight decay")
    conf = zoo.vgg16_conf(
        height=config["height"], width=config["width"],
        channels=config["channels"], num_classes=config["num_classes"],
        seed=seed, learning_rate=config["learning_rate"],
        data_type=config["data_type"])
    return MultiLayerNetwork(conf, device=device).init()


def params_tree(config, host):
    """[per-layer {name: numpy}] as `from_jax_params` takes it."""
    tree = [{} for _ in range(reference.n_layers(config))]
    for (index, name), a in host.items():
        tree[index][name] = a
    return tree


def state_tree(running):
    return None


def leaf_items(tree):
    for index, per in enumerate(tree):
        for name, a in per.items():
            yield (index, name), a
