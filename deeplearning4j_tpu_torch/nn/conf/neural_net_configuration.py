"""Configuration DSL: NeuralNetConfiguration.Builder -> MultiLayerConfiguration.
Port of deeplearning4j_tpu/nn/conf/neural_net_configuration.py: the same
builder (snake_case with camelCase aliases), global defaults, automatic
preprocessors and nIn inference, and the same JSON, so a document written
by either package loads in the other and `to_json` gives it back
unchanged:

    conf = (NeuralNetConfiguration.Builder()
            .seed(123)
            .updater("adam").learning_rate(1e-3)
            .list()
            .layer(0, DenseLayer(n_out=256, activation="relu"))
            .layer(1, OutputLayer(n_out=10, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
"""
from __future__ import annotations

import json

from .input_type import InputType
from .layers.base import LAYER_REGISTRY, LayerConf
from .preprocessors import (CnnToFeedForwardPreProcessor,
                            FeedForwardToCnnPreProcessor, InputPreProcessor)

_GLOBAL_DEFAULTS = dict(
    seed=123,
    activation=None,
    weight_init=None,
    dist=None,
    learning_rate=None,
    bias_learning_rate=None,
    bias_init=None,
    l1=None, l2=None, l1_bias=None, l2_bias=None,
    dropout=None,
    updater=None,
    momentum=None, rho=None, rms_decay=None, epsilon=None,
    adam_mean_decay=None, adam_var_decay=None,
    gradient_normalization=None, gradient_normalization_threshold=1.0,
    lr_policy=None, lr_policy_decay_rate=None, lr_policy_steps=None,
    lr_policy_power=None, lr_policy_max_iterations=None, lr_schedule=None,
    optimization_algo="stochastic_gradient_descent",
    num_iterations=1,
    mini_batch=True,
    minimize=True,
    use_drop_connect=False,
    data_type="float32",
)


class NeuralNetConfiguration:
    """Namespace mirroring the reference class; holds the Builder."""

    class Builder:
        def __init__(self):
            self.g = dict(_GLOBAL_DEFAULTS)

        # -- fluent setters (snake_case; camelCase aliases added below) ----
        def seed(self, v):
            self.g["seed"] = int(v); return self

        def activation(self, v):
            self.g["activation"] = v; return self

        def weight_init(self, v):
            self.g["weight_init"] = str(v).lower(); return self

        def dist(self, v):
            self.g["dist"] = v; return self

        def learning_rate(self, v):
            self.g["learning_rate"] = float(v); return self

        def bias_learning_rate(self, v):
            self.g["bias_learning_rate"] = float(v); return self

        def bias_init(self, v):
            self.g["bias_init"] = float(v); return self

        def l1(self, v):
            self.g["l1"] = float(v); return self

        def l2(self, v):
            self.g["l2"] = float(v); return self

        def dropout(self, v):
            self.g["dropout"] = float(v); return self

        drop_out = dropout

        def updater(self, v):
            self.g["updater"] = str(v).lower(); return self

        def momentum(self, v):
            self.g["momentum"] = float(v); return self

        def rho(self, v):
            self.g["rho"] = float(v); return self

        def rms_decay(self, v):
            self.g["rms_decay"] = float(v); return self

        def epsilon(self, v):
            self.g["epsilon"] = float(v); return self

        def adam_mean_decay(self, v):
            self.g["adam_mean_decay"] = float(v); return self

        def adam_var_decay(self, v):
            self.g["adam_var_decay"] = float(v); return self

        def gradient_normalization(self, v, threshold=None):
            self.g["gradient_normalization"] = v
            if threshold is not None:
                self.g["gradient_normalization_threshold"] = float(threshold)
            return self

        def gradient_normalization_threshold(self, v):
            self.g["gradient_normalization_threshold"] = float(v); return self

        def learning_rate_decay_policy(self, v):
            self.g["lr_policy"] = str(v).lower(); return self

        def lr_policy_decay_rate(self, v):
            self.g["lr_policy_decay_rate"] = float(v); return self

        def lr_policy_steps(self, v):
            self.g["lr_policy_steps"] = float(v); return self

        def lr_policy_power(self, v):
            self.g["lr_policy_power"] = float(v); return self

        def lr_policy_max_iterations(self, v):
            """Decay horizon for the 'poly' policy: lr*(1-it/max)^power."""
            self.g["lr_policy_max_iterations"] = float(v); return self

        def learning_rate_schedule(self, v):
            self.g["lr_schedule"] = dict(v); return self

        def optimization_algo(self, v):
            self.g["optimization_algo"] = str(v).lower(); return self

        def iterations(self, v):
            self.g["num_iterations"] = int(v); return self

        def mini_batch(self, v):
            self.g["mini_batch"] = bool(v); return self

        def minimize(self, v):
            self.g["minimize"] = bool(v); return self

        def regularization(self, v):
            # reference has a useRegularization flag gating l1/l2
            self.g["regularization"] = bool(v); return self

        def data_type(self, v):
            """'float32' | 'bfloat16' (compute dtype; params stay float32)."""
            self.g["data_type"] = str(v); return self

        def updater_state_dtype(self, v):
            """Storage dtype for updater state (Adam m/v, momentum...).
            'bfloat16' halves optimizer HBM traffic; see
            updaters.cast_updater_state for the accuracy tradeoff."""
            self.g["updater_state_dtype"] = str(v); return self

        def list(self):
            return ListBuilder(self.g)

        def graph_builder(self):
            from .computation_graph_configuration import GraphBuilder
            return GraphBuilder(self.g)

    # camelCase aliases for reference-identical call sites
    Builder.weightInit = Builder.weight_init
    Builder.learningRate = Builder.learning_rate
    Builder.biasLearningRate = Builder.bias_learning_rate
    Builder.biasInit = Builder.bias_init
    Builder.dropOut = Builder.dropout
    Builder.rmsDecay = Builder.rms_decay
    Builder.adamMeanDecay = Builder.adam_mean_decay
    Builder.adamVarDecay = Builder.adam_var_decay
    Builder.gradientNormalization = Builder.gradient_normalization
    Builder.gradientNormalizationThreshold = Builder.gradient_normalization_threshold
    Builder.learningRateDecayPolicy = Builder.learning_rate_decay_policy
    Builder.lrPolicyDecayRate = Builder.lr_policy_decay_rate
    Builder.lrPolicySteps = Builder.lr_policy_steps
    Builder.lrPolicyPower = Builder.lr_policy_power
    Builder.lrPolicyMaxIterations = Builder.lr_policy_max_iterations
    Builder.learningRateSchedule = Builder.learning_rate_schedule
    Builder.optimizationAlgo = Builder.optimization_algo
    Builder.miniBatch = Builder.mini_batch
    Builder.graphBuilder = Builder.graph_builder


class ListBuilder:
    """reference: NeuralNetConfiguration.ListBuilder ->
    MultiLayerConfiguration.Builder"""

    def __init__(self, global_conf):
        self.g = global_conf
        self.layers = {}
        self.preprocessors = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_type = None

    def layer(self, index_or_layer, layer=None):
        if layer is None:
            layer = index_or_layer
            index = len(self.layers)
        else:
            index = int(index_or_layer)
        if not isinstance(layer, LayerConf):
            raise TypeError(f"layer must be a LayerConf, got {type(layer)}")
        self.layers[index] = layer
        return self

    def input_pre_processor(self, index, preproc):
        self.preprocessors[int(index)] = preproc
        return self

    inputPreProcessor = input_pre_processor

    def backprop(self, v):
        self._backprop = bool(v); return self

    def pretrain(self, v):
        self._pretrain = bool(v); return self

    def backprop_type(self, v):
        self._backprop_type = str(v).lower(); return self

    backpropType = backprop_type

    def t_bptt_forward_length(self, v):
        self._tbptt_fwd = int(v); return self

    def t_bptt_backward_length(self, v):
        self._tbptt_back = int(v); return self

    tBPTTForwardLength = t_bptt_forward_length
    tBPTTBackwardLength = t_bptt_backward_length

    def set_input_type(self, input_type):
        self._input_type = input_type
        return self

    setInputType = set_input_type

    def build(self):
        n = len(self.layers)
        layer_list = [self.layers[i] for i in range(n)]
        layer_list = [l.apply_global_defaults(self.g) for l in layer_list]
        preprocessors = dict(self.preprocessors)

        # setInputType: walk layers, insert preprocessors + infer nIn
        # (reference MultiLayerConfiguration.Builder.build w/ InputType —
        #  Layer.getPreProcessorForInputType + setNIn chain)
        if self._input_type is not None:
            cur = self._input_type
            for i, layer in enumerate(layer_list):
                if i not in preprocessors:
                    pp = _infer_preprocessor(cur, layer)
                    if pp is not None:
                        preprocessors[i] = pp
                if i in preprocessors:
                    cur = preprocessors[i].get_output_type(cur)
                layer.set_n_in(cur, override=False)
                cur = layer.get_output_type(cur)

        return MultiLayerConfiguration(
            layers=layer_list,
            preprocessors=preprocessors,
            global_conf=dict(self.g),
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_type=self._input_type,
        )


def _infer_preprocessor(input_type, layer):
    """Automatic preprocessor insertion (reference: each conf layer's
    getPreProcessorForInputType)."""
    from .input_type import (ConvolutionalFlatInputType, ConvolutionalInputType,
                             FeedForwardInputType, RecurrentInputType)
    lt = getattr(layer, "layer_type", "")
    cnn_layer = lt in ("convolution", "subsampling", "batchnorm", "lrn",
                      "zeropadding", "spatial_dropout")
    if isinstance(input_type, ConvolutionalFlatInputType):
        if cnn_layer:
            return FeedForwardToCnnPreProcessor(
                input_type.height, input_type.width, input_type.depth)
        return None
    if isinstance(input_type, ConvolutionalInputType) and not cnn_layer:
        # shape-agnostic layers (activation/dropout/loss) pass CNN activations
        # through untouched — the reference returns a null preprocessor there
        if lt in ("dense", "output", "autoencoder", "embedding", "vae", "rbm"):
            return CnnToFeedForwardPreProcessor(
                input_type.height, input_type.width, input_type.channels)
    return None


class MultiLayerConfiguration:
    """reference: nn/conf/MultiLayerConfiguration.java (496 LoC)"""

    def __init__(self, layers, preprocessors, global_conf, backprop=True,
                 pretrain=False, backprop_type="standard", tbptt_fwd_length=20,
                 tbptt_back_length=20, input_type=None, iteration_count=0,
                 epoch_count=0):
        self.layers = layers
        self.preprocessors = preprocessors
        self.global_conf = global_conf
        self.backprop = backprop
        self.pretrain = pretrain
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.input_type = input_type
        # training progress counters live in the config, as in the reference
        # (NeuralNetConfiguration.iterationCount:119)
        self.iteration_count = iteration_count
        self.epoch_count = epoch_count

    # -- serde ----------------------------------------------------------
    def to_dict(self):
        return {
            "format": "deeplearning4j-tpu/MultiLayerConfiguration",
            "version": 1,
            "globalConf": {k: v for k, v in self.global_conf.items()
                           if v is not None},
            "layers": [l.to_dict() for l in self.layers],
            "preprocessors": {str(i): p.to_dict()
                              for i, p in self.preprocessors.items()},
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backpropType": self.backprop_type,
            "tbpttFwdLength": self.tbptt_fwd_length,
            "tbpttBackLength": self.tbptt_back_length,
            "inputType": self.input_type.to_dict() if self.input_type else None,
            "iterationCount": self.iteration_count,
            "epochCount": self.epoch_count,
        }

    def to_json(self, indent=2):
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d):
        g = dict(_GLOBAL_DEFAULTS)
        g.update(d.get("globalConf", {}))
        layers = [LayerConf.from_dict(ld) for ld in d["layers"]]
        preprocessors = {int(i): InputPreProcessor.from_dict(pd)
                         for i, pd in d.get("preprocessors", {}).items()}
        it = d.get("inputType")
        return MultiLayerConfiguration(
            layers=layers, preprocessors=preprocessors, global_conf=g,
            backprop=d.get("backprop", True), pretrain=d.get("pretrain", False),
            backprop_type=d.get("backpropType", "standard"),
            tbptt_fwd_length=d.get("tbpttFwdLength", 20),
            tbptt_back_length=d.get("tbpttBackLength", 20),
            input_type=InputType.from_dict(it) if it else None,
            iteration_count=d.get("iterationCount", 0),
            epoch_count=d.get("epochCount", 0),
        )

    @staticmethod
    def from_json(s):
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def to_yaml(self):
        """YAML serde — reference MultiLayerConfiguration.toYaml/fromYaml
        (nn/conf/MultiLayerConfiguration.java, Jackson YAML mapper).
        Normalized through JSON types so tuples serialize as lists (the
        same representation to_json produces)."""
        import yaml
        return yaml.safe_dump(json.loads(self.to_json()), sort_keys=False)

    toYaml = to_yaml

    @staticmethod
    def from_yaml(s):
        import yaml
        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))

    fromYaml = from_yaml

    def clone(self):
        return MultiLayerConfiguration.from_dict(self.to_dict())
