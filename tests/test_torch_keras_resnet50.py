"""A real ``keras.applications.ResNet50`` (``tests/test_keras_resnet50.py``)
imported by the port and by the JAX package from the same ``.h5``: the
params and batch-norm states equal bit for bit, the port's ``output()``
within 1e-3 of Keras's predictions (the JAX test's tolerance), and one
finite training step. The file is saved here by the environment's Keras
(seeded, ``weights=None``); skipped without Keras."""

import numpy as np
import pytest

from deeplearning4j_tpu.keras.keras_import import KerasModelImport as JImport
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.keras.keras_import import KerasModelImport
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph


@pytest.fixture(scope="module")
def resnet50(tmp_path_factory):
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(42)
    model = keras.applications.ResNet50(weights=None)
    path = str(tmp_path_factory.mktemp("rn50") / "resnet50.h5")
    model.save(path)
    x = np.random.default_rng(0).normal(size=(2, 224, 224, 3)).astype(
        np.float32)
    y = model.predict(x, verbose=0)
    net = KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    return path, x, y, net


def test_resnet50_imports_as_the_jax_import_and_matches_keras(resnet50):
    path, x, y, net = resnet50
    assert isinstance(net, ComputationGraph)
    # keras counts 25,636,712 incl. BN moving stats (53,120), which live
    # in net.states here, not params
    assert net.num_params() == 25_583_592
    jnet = JImport.import_keras_model_and_weights(path)
    assert net.params_flat().tobytes() == \
        np.asarray(jnet.params_flat()).tobytes()
    for name, state in jnet.states.items():
        for k, v in state.items():
            assert net.states[name][k].numpy().tobytes() == \
                np.asarray(v, np.float32).tobytes(), (name, k)
    out = net.output(x).numpy()
    assert out.shape == (2, 1000)
    np.testing.assert_allclose(out, y, atol=1e-3)


def test_resnet50_import_is_trainable(resnet50):
    path, x, _, net = resnet50
    labels = np.eye(1000, dtype=np.float32)[[3, 7]]
    assert np.isfinite(float(net.fit_batch(DataSet(x, labels))))
