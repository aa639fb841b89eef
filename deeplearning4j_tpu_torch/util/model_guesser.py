"""ModelGuesser — heuristically load any model or configuration artifact.

Port of deeplearning4j_tpu/util/model_guesser.py, the equivalent of
reference deeplearning4j-core util/ModelGuesser.java: `loadModelGuess` tries the serialized-model formats
in turn (MultiLayerNetwork zip, ComputationGraph zip) and `loadConfigGuess`
tries every configuration representation (MultiLayerConfiguration /
ComputationGraphConfiguration as JSON or YAML). A network is built on
`device`: the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import json
import os
import zipfile

from . import model_serializer


def load_config_guess(path_or_str):
    """Parse a configuration from a file path or a raw JSON/YAML string,
    trying MultiLayerConfiguration then ComputationGraphConfiguration in
    each format. reference: ModelGuesser.loadConfigGuess."""
    from ..nn.conf.computation_graph_configuration import \
        ComputationGraphConfiguration
    from ..nn.conf.neural_net_configuration import MultiLayerConfiguration

    text = path_or_str
    if isinstance(path_or_str, (str, os.PathLike)) and \
            os.path.exists(str(path_or_str)):
        with open(path_or_str, "r", encoding="utf-8") as fh:
            text = fh.read()

    errors = []
    for parse in (json.loads, _yaml_load):
        try:
            d = parse(text)
        except Exception as e:
            errors.append(e)
            continue
        if not isinstance(d, dict):
            errors.append(ValueError("not a mapping"))
            continue
        fmt = d.get("format", "")
        order = ([ComputationGraphConfiguration, MultiLayerConfiguration]
                 if "ComputationGraph" in fmt
                 else [MultiLayerConfiguration, ComputationGraphConfiguration])
        for cls in order:
            try:
                return cls.from_dict(d)
            except Exception as e:
                errors.append(e)
    raise ValueError(
        f"Unable to guess configuration format ({len(errors)} attempts): "
        f"{errors[-1] if errors else 'empty input'}")


loadConfigGuess = load_config_guess


def load_model_guess(path, load_updater=True, device=None):
    """Load a model OR a bare configuration from `path`, whichever it is.
    Zip archives restore a full network (params + updater state); JSON/YAML
    files produce an uninitialized network from the parsed configuration.
    The network lives on `device` (the card unless "cpu" is asked for).
    reference: ModelGuesser.loadModelGuess."""
    p = str(path)
    if zipfile.is_zipfile(p):
        return model_serializer.restore_model(p, load_updater, device)
    conf = load_config_guess(p)
    from ..nn.conf.computation_graph_configuration import \
        ComputationGraphConfiguration
    if isinstance(conf, ComputationGraphConfiguration):
        from ..nn.graph import ComputationGraph
        return ComputationGraph(conf, device=device)
    from ..nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(conf, device=device)


loadModelGuess = load_model_guess


def _yaml_load(text):
    import yaml
    return yaml.safe_load(text)
