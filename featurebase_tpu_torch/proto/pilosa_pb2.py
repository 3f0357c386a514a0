"""Protocol-buffer messages of the gRPC wire schema (pilosa.proto beside
this file: package featurebase_tpu, service featurebase_tpu.Pilosa).

Own copy of featurebase_tpu/proto/pilosa_pb2.py, the same serialized
descriptor under this package's file name, with the same message and
service names on the wire, so a client of either package talks to a server
of either.  The messages are built in a private descriptor pool, not in
protobuf's default one: a process that imports both packages would
otherwise register the symbols featurebase_tpu.* twice, which protobuf
refuses.  There is no protoc step; regenerate the literal from
pilosa.proto with protoc's descriptor output if the schema changes.
"""
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

POOL = _descriptor_pool.DescriptorPool()

DESCRIPTOR = POOL.AddSerializedFile(
    b'\n(featurebase_tpu_torch/proto/pilosa.proto\x12\x0ffeaturebase_tpu'
    b'"-\n\x0fQueryPQLRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\x0b\n'
    b'\x03pql\x18\x02 \x01(\t"\x1e\n\x0fQuerySQLRequest\x12\x0b\n\x03sql'
    b'\x18\x01 \x01(\t",\n\nColumnInfo\x12\x0c\n\x04name\x18\x01 \x01(\t'
    b'\x12\x10\n\x08datatype\x18\x02 \x01(\t"\xaa\x01\n\x0eColumnRespons'
    b'e\x12\x14\n\nstring_val\x18\x01 \x01(\tH\x00\x12\x14\n\nuint64_val'
    b'\x18\x02 \x01(\x04H\x00\x12\x13\n\tint64_val\x18\x03 \x01(\x03H'
    b'\x00\x12\x12\n\x08bool_val\x18\x04 \x01(\x08H\x00\x12\x15\n\x0bflo'
    b'at64_val\x18\x05 \x01(\x01H\x00\x12\x12\n\x08json_val\x18\x06 \x01'
    b'(\tH\x00\x12\x0f\n\x07is_null\x18\x07 \x01(\x08B\x07\n\x05value"m'
    b'\n\x0bRowResponse\x12,\n\x07headers\x18\x01 \x03(\x0b2\x1b.feature'
    b'base_tpu.ColumnInfo\x120\n\x07columns\x18\x02 \x03(\x0b2\x1f.featu'
    b'rebase_tpu.ColumnResponse"i\n\rTableResponse\x12,\n\x07headers\x18'
    b'\x01 \x03(\x0b2\x1b.featurebase_tpu.ColumnInfo\x12*\n\x04rows\x18'
    b'\x02 \x03(\x0b2\x1c.featurebase_tpu.RowResponse"0\n\x0eStatusRespo'
    b'nse\x12\r\n\x05state\x18\x01 \x01(\t\x12\x0f\n\x07indexes\x18\x02 '
    b'\x03(\t"0\n\x12CreateIndexRequest\x12\x0c\n\x04name\x18\x01 \x01('
    b'\t\x12\x0c\n\x04keys\x18\x02 \x01(\x08"\x15\n\x13CreateIndexRespon'
    b'se"\x1f\n\x0fGetIndexRequest\x12\x0c\n\x04name\x18\x01 \x01(\t"'
    b'\x15\n\x05Index\x12\x0c\n\x04name\x18\x01 \x01(\t"9\n\x10GetIndexR'
    b'esponse\x12%\n\x05index\x18\x01 \x01(\x0b2\x16.featurebase_tpu.Ind'
    b'ex"\x13\n\x11GetIndexesRequest"=\n\x12GetIndexesResponse\x12\'\n'
    b'\x07indexes\x18\x01 \x03(\x0b2\x16.featurebase_tpu.Index""\n\x12De'
    b'leteIndexRequest\x12\x0c\n\x04name\x18\x01 \x01(\t"\x15\n\x13Delet'
    b'eIndexResponse"G\n\x0eInspectRequest\x12\r\n\x05index\x18\x01 \x01'
    b'(\t\x12\x0f\n\x07columns\x18\x02 \x03(\x04\x12\x15\n\rfilter_field'
    b's\x18\x03 \x03(\t2\x84\x06\n\x06Pilosa\x12N\n\x08QuerySQL\x12 .fea'
    b'turebase_tpu.QuerySQLRequest\x1a\x1c.featurebase_tpu.RowResponse"'
    b'\x000\x01\x12S\n\rQuerySQLUnary\x12 .featurebase_tpu.QuerySQLReque'
    b'st\x1a\x1e.featurebase_tpu.TableResponse"\x00\x12N\n\x08QueryPQL'
    b'\x12 .featurebase_tpu.QueryPQLRequest\x1a\x1c.featurebase_tpu.RowR'
    b'esponse"\x000\x01\x12S\n\rQueryPQLUnary\x12 .featurebase_tpu.Query'
    b'PQLRequest\x1a\x1e.featurebase_tpu.TableResponse"\x00\x12L\n\x07In'
    b'spect\x12\x1f.featurebase_tpu.InspectRequest\x1a\x1c.featurebase_t'
    b'pu.RowResponse"\x000\x01\x12Z\n\x0bCreateIndex\x12#.featurebase_tp'
    b'u.CreateIndexRequest\x1a$.featurebase_tpu.CreateIndexResponse"\x00'
    b'\x12Q\n\x08GetIndex\x12 .featurebase_tpu.GetIndexRequest\x1a!.feat'
    b'urebase_tpu.GetIndexResponse"\x00\x12W\n\nGetIndexes\x12".featureb'
    b'ase_tpu.GetIndexesRequest\x1a#.featurebase_tpu.GetIndexesResponse"'
    b'\x00\x12Z\n\x0bDeleteIndex\x12#.featurebase_tpu.DeleteIndexRequest'
    b'\x1a$.featurebase_tpu.DeleteIndexResponse"\x00b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(
    DESCRIPTOR, "featurebase_tpu_torch.proto.pilosa_pb2", globals())
