"""What the port's server surface leaves to a later item says so: the
subcommand below raises NotImplementedError naming its ROADMAP.md queue 1
item (15, DAX)."""
import pytest
import torch

from featurebase_tpu_torch import cli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def message(item: int) -> str:
    return f"(ROADMAP.md queue 1 item {item})"


CLI = [
    (15, ["dax"]),
]


@pytest.mark.parametrize("item,argv", CLI,
                         ids=["cli-" + a[0] for _, a in CLI])
def test_waits_for_its_item(item, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=message(item).replace(
            "(", r"\(").replace(")", r"\)")):
        cli.main(argv)
